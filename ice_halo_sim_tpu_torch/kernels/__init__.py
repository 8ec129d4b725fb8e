"""CUDA kernel build/launch plumbing and the two kernel sets an Engine can
run: ``"cuda"`` (the wrappers, which launch the CUDA kernels on CUDA
tensors) and ``"plain"`` (the plain PyTorch twins, on any device)."""

from __future__ import annotations

from typing import Callable, NamedTuple


class KernelSet(NamedTuple):
    name: str
    trace_emit: Callable
    pack_payload_blocks: Callable
    scatter_blocks_multi: Callable
    scatter_blocks: Callable
    compact_rows: Callable
    fused_scan_extract: Callable
    sandwich_pass: Callable
    sort_pairs: Callable
    trace_layer: Callable


def kernel_set(kind: str) -> KernelSet:
    from ice_halo_sim_tpu_torch.core import (block_ops, radix_sort, sandwich, seg_scan, trace_emit,
                                            trace_soa)

    if kind == "cuda":
        return KernelSet("cuda", trace_emit.trace_emit,
                         block_ops.pack_payload_blocks,
                         block_ops.scatter_blocks_multi,
                         block_ops.scatter_blocks,
                         block_ops.compact_rows,
                         seg_scan.fused_scan_extract,
                         sandwich.sandwich_pass,
                         radix_sort.sort_pairs,
                         trace_soa.trace_layer_cuda)
    if kind == "plain":
        return KernelSet("plain", trace_emit.trace_emit_plain,
                         block_ops.pack_payload_blocks_plain,
                         block_ops.scatter_blocks_multi_plain,
                         block_ops.scatter_blocks_plain,
                         block_ops.compact_rows_plain,
                         seg_scan.fused_scan_extract_plain,
                         sandwich.sandwich_pass_plain,
                         radix_sort.sort_pairs_plain,
                         trace_soa.trace_layer_soa)
    raise ValueError(f"kernels must be 'cuda' or 'plain', got {kind!r}")
