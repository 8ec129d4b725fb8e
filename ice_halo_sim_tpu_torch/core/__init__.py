"""The port's core stages: sampling, optics, the trace, accumulation, color.

On the CPU, torch computes sqrt, exp, log, sin, cos, asin and its other
elementwise functions with MKL's vector math, on chunks of 2048 elements
spread over its OpenMP threads. MKL sets that math up on its first call in
a process. When the first call comes from several threads at once (any such
function on more than 2048 elements), a thread can compute its chunk with
an approximation good to some 1e-4 relative, where MKL's own error is one
ulp. The one-element call below runs on the importing thread alone, so the
setup is done before any stage here runs such a function in parallel.
"""

import torch

torch.sqrt(torch.ones(1))
