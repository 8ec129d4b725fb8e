"""Structural rules of the PyTorch port:
  - the port (and what chip_smoke.py imports) never imports jax, the JAX
    package or bench.py;
  - the port's copies of the JAX package's JAX-free modules still equal
    their sources after the import rewrite;
  - no file of the port refers to the reference checkout's absolute path;
  - every CUDA entry point returns cudaGetLastError() after its launches,
    and every wrapper checks the code it returns;
  - each kernel's launch counter is bumped in exactly one place.
"""

import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import ice_halo_sim_tpu_torch

# The suite runs under several xdist workers; keep each to two torch threads.
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(ice_halo_sim_tpu_torch.__file__)


def _port_files(exts):
    out = []
    for d, _, files in os.walk(PKG):
        if "_build" in d or "__pycache__" in d:
            continue
        out += [os.path.join(d, f) for f in files if f.endswith(exts)]
    return sorted(out)


def test_port_imports_no_jax():
    mods = [m.name for m in pkgutil.walk_packages([PKG], "ice_halo_sim_tpu_torch.")]
    assert "ice_halo_sim_tpu_torch.engine.simulator" in mods
    # The serving path's modules are among those walked.
    assert {"ice_halo_sim_tpu_torch.engine.server", "ice_halo_sim_tpu_torch.engine.ev_auto",
            "ice_halo_sim_tpu_torch.engine.overlay", "ice_halo_sim_tpu_torch.engine.checkpoint",
            "ice_halo_sim_tpu_torch.core.mesh", "ice_halo_sim_tpu_torch.gui",
            "ice_halo_sim_tpu_torch.gui.app", "ice_halo_sim_tpu_torch.engine.debug",
            "ice_halo_sim_tpu_torch.kernels.capi", "ice_halo_sim_tpu_torch.core.trace",
            "ice_halo_sim_tpu_torch.parallel.sharding",
            "ice_halo_sim_tpu_torch.parallel.distributed",
            "ice_halo_sim_tpu_torch.bench_matrix"} <= set(mods)
    code = (
        "import sys, importlib\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import ice_halo_sim_tpu_torch\n"
        "ice_halo_sim_tpu_torch.Engine, ice_halo_sim_tpu_torch.load_jax_checkpoint\n"
        "ice_halo_sim_tpu_torch.Server, ice_halo_sim_tpu_torch.save_checkpoint\n"
        "ice_halo_sim_tpu_torch.load_checkpoint, ice_halo_sim_tpu_torch.project_to_json\n"
        "ice_halo_sim_tpu_torch.load_project, ice_halo_sim_tpu_torch.SceneBuilder\n"
        "from ice_halo_sim_tpu_torch.parallel import ShardedEngine, make_mesh\n"
        "from ice_halo_sim_tpu_torch.parallel.distributed import MultiHostEngine\n"
        "import chip_smoke\n"
        "roots = ('jax', 'jaxlib', 'ice_halo_sim_tpu', 'bench')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in roots)\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-3000:]


COPIED_MODULES = [
    "config/__init__.py", "config/schema.py", "config/loader.py", "config/builder.py",
    "config/serialize.py", "config/validation.py", "core/latlut.py",
    "utils/__init__.py", "utils/env_knobs.py", "utils/log.py", "utils/png.py",
    "engine/ev_auto.py",
]


def test_copied_modules_equal_their_sources():
    """The port keeps its own copy of every JAX-free module it uses. Each
    copy is its source with the package name rewritten in imports and the
    reference checkout's path made relative; anything else is drift."""
    jax_pkg = os.path.join(ROOT, "ice_halo_sim_tpu")
    checkout = os.sep + os.path.join("root", "reference")
    for rel in COPIED_MODULES:
        with open(os.path.join(jax_pkg, rel)) as f:
            want = f.read().replace("ice_halo_sim_tpu", "ice_halo_sim_tpu_torch")
        want = want.replace(checkout, "reference")
        with open(os.path.join(PKG, rel)) as f:
            assert f.read() == want, rel
    with open(os.path.join(jax_pkg, "data", "cie_data.npz"), "rb") as a, \
            open(os.path.join(PKG, "data", "cie_data.npz"), "rb") as b:
        assert a.read() == b.read()
    assert ice_halo_sim_tpu_torch.load_project.__module__ == \
        "ice_halo_sim_tpu_torch.config.loader"


NATIVE_COPIES = ["src/scene_builder.cpp", "include/iht.h", "examples/smoke.c"]


def _native_source(rel):
    """A file of the JAX package's native/ with the reference checkout's
    path made relative, as in every copy of the port."""
    with open(os.path.join(ROOT, "native", rel)) as f:
        return f.read().replace(os.sep + os.path.join("root", "reference"), "reference")


def test_native_sources_are_copies():
    """The port's C API is the JAX package's: iht.h, scene_builder.cpp and
    smoke.c are copies; c_api.cpp differs only in the modules it imports
    (the port's server, log and mesh) and in the three comments that name
    the engine; no C source names a module of the JAX package."""
    pkg_native = os.path.join(PKG, "native")
    for rel in NATIVE_COPIES:
        with open(os.path.join(pkg_native, rel)) as f:
            assert f.read() == _native_source(rel), rel
    with open(os.path.join(pkg_native, "src", "c_api.cpp")) as f:
        got = f.read().splitlines()
    want = _native_source("src/c_api.cpp").splitlines()
    assert len(got) == len(want)
    diff = [(i + 1, a, b) for i, (a, b) in enumerate(zip(want, got)) if a != b]
    assert [d[0] for d in diff] == [5, 7, 98, 135, 137, 731, 752, 786], diff
    for _, a, b in diff:
        assert "ice_halo_sim_tpu_torch" in b or "the port's engine" in b, b
        if "ice_halo_sim_tpu." in a:
            assert b == a.replace("ice_halo_sim_tpu.", "ice_halo_sim_tpu_torch."), b
    for path in _port_files((".cpp", ".c", ".h")):
        with open(path) as f:
            src = f.read()
        assert not re.search(r"ice_halo_sim_tpu(?!_torch)\b", src), path


def test_gui_page_is_the_jax_page():
    """The port's viewer page is the JAX package's, the package name
    rewritten."""
    from ice_halo_sim_tpu.gui import app as jax_app

    from ice_halo_sim_tpu_torch.gui import app

    assert app._PAGE == jax_app._PAGE.replace("ice_halo_sim_tpu", "ice_halo_sim_tpu_torch")


def test_no_reference_checkout_paths():
    files = _port_files((".py", ".cu", ".cuh", ".cpp", ".c", ".h"))
    files += [os.path.join(ROOT, "chip_smoke.py")]
    files += [os.path.join(ROOT, "tests", f) for f in os.listdir(os.path.join(ROOT, "tests"))
              if f.startswith("test_torch_")]
    needle = os.sep + os.path.join("root", "reference")
    for path in files:
        with open(path) as f:
            assert needle not in f.read(), path


def test_cuda_entry_points_return_launch_error():
    entries = 0
    for path in _port_files((".cu",)):
        src = open(path).read()
        for m in re.finditer(r'extern "C" int (iht_\w+)\([^)]*\)\s*\{', src):
            depth, i = 1, m.end()
            while depth:
                depth += {"{": 1, "}": -1}.get(src[i], 0)
                i += 1
            body = src[m.end():i]
            entries += 1
            assert body.rstrip().rstrip("}").rstrip().endswith(
                "return (int)cudaGetLastError();"), m.group(1)
            # Every launch is followed by a launch-error read before the next.
            parts = body.split("<<<")
            for after in parts[1:]:
                assert "cudaGetLastError()" in after, m.group(1)
    assert entries == 12


def test_wrappers_check_every_kernel_call():
    calls = 0
    for path in _port_files((".py",)):
        src = open(path).read()
        for m in re.finditer(r"code = (?:build\.lib\(\)|lib)\.(iht_\w+)\(", src):
            calls += 1
            assert re.search(r"build\.check\(code, ", src[m.end():m.end() + 600]), (
                path, m.group(1))
    assert calls == 12


def test_every_kernel_call_runs_on_its_tensors_device():
    """An entry point launches on the CUDA runtime's current device, so each
    C call sits inside ``torch.cuda.device`` of its tensors' device (the
    block just above the call), and a graph is captured and replayed under
    its engine's device. The block scatter sizes its grid by the current
    device's multiprocessors, looked up on every call (no first device
    cached in a static)."""
    calls = 0
    for path in _port_files((".py",)):
        lines = open(path).read().splitlines()
        for i, line in enumerate(lines):
            if re.search(r"code = (?:build\.lib\(\)|lib)\.iht_\w+\(", line):
                calls += 1
                assert re.search(r"with torch\.cuda\.device\(\w+(\.device)?\):$",
                                 lines[i - 1].strip()), (path, i + 1)
    assert calls == 12
    # engine/graph.py: each of its two captures (BatchGraph, GradGraph) and
    # its one replay helper under the graph's device.
    graph = open(os.path.join(PKG, "engine", "graph.py")).read()
    assert graph.count("with torch.cuda.device(") == 3
    assert graph.count(".replay()") == 1 and graph.count("torch.cuda.graph(") == 1
    cu = open(os.path.join(PKG, "csrc", "block_ops.cu")).read()
    assert "static int n_sm" not in cu and "cudaGetDevice(&device)" in cu


def test_each_launch_counter_bumped_once():
    from ice_halo_sim_tpu_torch.kernels import build

    srcs = "".join(open(p).read() for p in _port_files((".py",)))
    assert len(build.LAUNCHES) == 17 and {"trace_emit_pool", "trace_layer"} <= set(build.LAUNCHES)
    assert {"sandwich_lane", "sandwich_sublane", "sandwich_iota", "extract_blocks"} <= \
        set(build.LAUNCHES)
    assert {"pack_valid_blocks", "scatter_blocks", "compact_rows"} <= set(build.LAUNCHES)
    # The radix sort's pass counter adds its launch's passes.
    for name in build.LAUNCHES:
        step = "n" if name == "radix_sort_pass" else "1"
        assert srcs.count(f'build.LAUNCHES["{name}"] += {step}') == 1, name


def test_compositor_is_a_copy_but_for_its_docstring():
    """engine/compositor.py is a copy of the JAX package's numpy module; only
    the module docstring differs (it names no file outside the repo)."""
    def body(path):
        return open(path).read().split('"""', 2)[2]

    assert body(os.path.join(PKG, "engine", "compositor.py")) == \
        body(os.path.join(ROOT, "ice_halo_sim_tpu", "engine", "compositor.py"))


def test_pack_valid_blocks_never_falls_to_the_plain_version():
    """A tensor that is not on the CPU goes to the kernel or raises: bad
    arguments raise ValueError before any launch, good ones reach the kernel
    build (absent here), and nothing computes the plain version instead.
    Meta tensors stand in for CUDA tensors: the wrappers branch on
    ``device.type == "cpu"`` alone."""
    import pytest

    from ice_halo_sim_tpu_torch.core import block_ops
    from ice_halo_sim_tpu_torch.kernels import build

    def meta(n, dtype=torch.float32):
        return torch.empty(n, dtype=dtype, device="meta")

    before = dict(build.LAUNCHES)
    with pytest.raises(ValueError, match="multiple of block|N % block"):
        block_ops.pack_valid_blocks(meta(4096 + 7, torch.int32), [meta(4096 + 7)], 9, 4096)
    with pytest.raises(ValueError, match="1 or 2 payload columns"):
        block_ops.pack_valid_blocks(meta(4096, torch.int32), [meta(4096)] * 3, 9, 4096)
    with pytest.raises(ValueError, match="1 or 2 payload columns"):
        block_ops.pack_valid_blocks(meta(4096, torch.int32), [], 9, 4096)
    with pytest.raises(ValueError, match="32-bit"):
        block_ops.pack_valid_blocks(meta(4096, torch.int32), [meta(4096, torch.float64)],
                                    9, 4096)
    for call in (
        lambda: block_ops.pack_valid_blocks(meta(4096, torch.int32), [meta(4096)], 9, 4096),
        lambda: block_ops.scatter_blocks([torch.empty((1, 4096), device="meta")],
                                         meta(1, torch.int32), 4096, 4096),
    ):
        with pytest.raises(Exception) as exc:
            call()
        assert not isinstance(exc.value, (ValueError, AssertionError)), exc.value
    assert build.LAUNCHES == before


def test_scatter_and_compaction_never_fall_to_the_plain_version():
    """The block scatter (K3, K3', all columns and a permutation in one
    launch) and compact_rows on tensors that are not on the CPU: bad
    arguments raise ValueError before any launch, good ones reach the kernel
    build (absent here), and no counter moves. Meta tensors stand in for
    CUDA tensors."""
    import pytest

    from ice_halo_sim_tpu_torch.core import block_ops
    from ice_halo_sim_tpu_torch.kernels import build, kernel_set

    def meta(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    cols, start = [meta((3, 1024))] * 7, meta(3, torch.int32)
    before = dict(build.LAUNCHES)
    with pytest.raises(ValueError, match="1 to 8 columns"):
        block_ops.scatter_blocks([meta((3, 1024))] * 9, start, 4096, 1024)
    with pytest.raises(ValueError, match="perm must be"):
        block_ops.scatter_blocks(cols, start, 4096, 1024, perm=meta((3, 1024), torch.int64))
    with pytest.raises(ValueError, match="columns \\[G, blk\\]"):
        block_ops.scatter_blocks(cols + [meta((2, 1024))], start, 4096, 1024)
    with pytest.raises(ValueError, match="blocks of 4096"):
        block_ops.compact_rows(meta(8192, torch.int32), [meta(8192)], 4096, 2048)
    with pytest.raises(ValueError, match="1 to 3 payload"):
        block_ops.compact_rows(meta(8192, torch.int32), [meta(8192)] * 4, 4096, 4096)
    with pytest.raises(ValueError, match="one length"):
        block_ops.compact_rows(meta(8192, torch.int32), [meta(8191)], 4096, 4096)
    for call in (
        lambda: block_ops.scatter_blocks(cols, start, 4096, 1024,
                                         perm=meta((3, 1024), torch.int32)),
        lambda: block_ops.scatter_blocks_multi(cols[:2], start, 4096, 1024,
                                               marker_tail=(100, 50, 7, 127)),
        lambda: block_ops.compact_rows(meta(8192 + 5, torch.int32), [meta(8192 + 5)] * 3,
                                       4096, 4096),
    ):
        with pytest.raises(Exception) as exc:
            call()
        assert not isinstance(exc.value, (ValueError, AssertionError)), exc.value
    assert build.LAUNCHES == before
    assert kernel_set("cuda").compact_rows is block_ops.compact_rows
    assert kernel_set("plain").compact_rows is block_ops.compact_rows_plain
    assert kernel_set("cuda").scatter_blocks is block_ops.scatter_blocks


def test_sandwich_wrappers_never_fall_to_the_plain_version():
    """K7, K8, P1 and P2 on a tensor that is not on the CPU: bad arguments
    raise ValueError before any launch, good ones reach the kernel build
    (absent here); nothing computes the plain version instead and no counter
    moves. Meta tensors stand in for CUDA tensors."""
    import pytest

    from ice_halo_sim_tpu_torch import probe_sandwich, probe_scatter
    from ice_halo_sim_tpu_torch.core import sandwich
    from ice_halo_sim_tpu_torch.kernels import build, kernel_set

    def meta(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    def rows(n=1000, k=16, c=3):
        return (meta(n, torch.int32), meta(n), meta(n, torch.int32), meta((k, c)))

    tile, cl = meta((8, 384)), meta(8, torch.int32)
    before = dict(build.LAUNCHES)
    with pytest.raises(ValueError, match="layout"):
        sandwich.sandwich_pass(tile, cl, *rows(), k_pool=16, layout="rows")
    with pytest.raises(ValueError, match="1 or 3 channels"):
        sandwich.sandwich_pass(meta((8, 256)), cl, *rows(c=2), k_pool=16)
    with pytest.raises(ValueError, match="k_pool"):
        sandwich.sandwich_pass(tile, cl, *rows(k=256), k_pool=256)
    with pytest.raises(ValueError, match="table must be"):
        sandwich.sandwich_pass(tile, cl, *rows(k=8), k_pool=16)
    with pytest.raises(ValueError, match="chunk list"):
        sandwich.sandwich_pass(tile, meta(9, torch.int32), *rows(), k_pool=16)
    with pytest.raises(ValueError, match="one length"):
        sandwich.sandwich_pass(tile, cl, meta(999, torch.int32), *rows()[1:], k_pool=16)
    with pytest.raises(ValueError, match="extract_blocks takes"):
        probe_scatter.extract_blocks(meta((4, 512)), meta(4, torch.int32), 4096, 1024)
    for call in (
        lambda: sandwich.sandwich_pass(tile, cl, *rows(), k_pool=16),
        lambda: sandwich.sandwich_pass(tile, cl, *rows(), k_pool=16, layout="sublane",
                                       precise=True),
        lambda: sandwich.sandwich_pass(meta((8, 128)), cl, *rows(c=1), k_pool=16),
        lambda: probe_sandwich.sandwich_iota(*rows(), nhi=8, k_pool=16),
        lambda: probe_scatter.extract_blocks(meta((4, 1024)), meta(4, torch.int32), 4096, 1024),
    ):
        with pytest.raises(Exception) as exc:
            call()
        assert not isinstance(exc.value, (ValueError, AssertionError)), exc.value
    assert build.LAUNCHES == before
    # The kernel sets: the wrapper in "cuda", the plain version in "plain".
    assert kernel_set("cuda").sandwich_pass is sandwich.sandwich_pass
    assert kernel_set("plain").sandwich_pass is sandwich.sandwich_pass_plain


def test_sandwich_source_holds_no_library_product():
    """The sandwich path is a scatter-add written by hand into shared memory:
    no one-hot product (no mma.sync, no wmma), no atomics (a reduction by
    key per slab of rows; the grouping ranks rows by warp votes), and no
    library product or scatter in the wrapper module outside the plain
    version."""
    cu = open(os.path.join(PKG, "csrc", "sandwich.cu")).read()
    for word in ("mma.sync", "wmma", "mma_sync", "<mma.h>", "atomicAdd", "atomicCAS"):
        assert word not in cu, word
    assert "__match_any_sync" in cu and "cudaFuncAttributeMaxDynamicSharedMemorySize" in cu
    for entry in ("iht_sandwich_lane", "iht_sandwich_sublane", "iht_sandwich_iota"):
        assert f'extern "C" int {entry}(' in cu
    src = open(os.path.join(PKG, "core", "sandwich.py")).read()
    wrapper = src[src.index("def sandwich_pass("):src.index("def assemble_image(")]
    for word in ("matmul", "index_add", "scatter_add", "torch.compile", "einsum", "@"):
        assert word not in wrapper, word
    sim = open(os.path.join(PKG, "engine", "simulator.py")).read()
    assert "degraded" not in sim.replace("``+degraded``", "")


_PROFILER_MODULES = ("torch.profiler", "torch.autograd.profiler", "torch._C._profiler",
                     "torch._C._autograd")


def _profiler_uses(path: str) -> list:
    """The places in a Python file that import or reach torch's profiler:
    import statements of it, and attribute chains such as
    torch.profiler.profile or torch.autograd.profiler.record_function."""
    import ast

    tree = ast.parse(open(path).read(), path)
    uses = []

    def dotted(node):
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            parts.append(node.id)
        return ".".join(reversed(parts))

    def hits(name):
        return any(name == m or name.startswith(m + ".") for m in _PROFILER_MODULES)

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            uses += [(node.lineno, a.name) for a in node.names if hits(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [f"{node.module}.{a.name}" for a in node.names]
            uses += [(node.lineno, n) for n in names if hits(node.module) or hits(n)]
        elif isinstance(node, ast.Attribute) and hits(dotted(node)):
            uses.append((node.lineno, dotted(node)))
    return uses


HELPER = os.path.join(PKG, "utils", "profiling.py")


@pytest.mark.parametrize("where", ["the port", "chip_smoke.py"])
def test_only_the_helper_reaches_torch_profiler(where):
    """Every torch.profiler window of the port and of chip_smoke.py opens in
    utils/profiling.py (device_profile): no other file imports or reaches
    the profiler."""
    files = ([f for f in _port_files((".py",)) if f != HELPER] if where == "the port"
             else [os.path.join(ROOT, "chip_smoke.py")])
    assert len(files) > (40 if where == "the port" else 0)
    bad = {os.path.relpath(f, ROOT): u for f in files if (u := _profiler_uses(f))}
    assert not bad, bad


def test_the_helper_is_where_the_profiler_is_reached():
    """The check above is not vacuous: it finds the helper's own import, and
    an attribute chain in a sample."""
    assert any(name.startswith("torch.profiler") for _, name in _profiler_uses(HELPER))
    import tempfile

    with tempfile.NamedTemporaryFile("w", suffix=".py", delete=False) as f:
        f.write("import torch\nwith torch.autograd.profiler.profile():\n    pass\n")
    try:
        assert [n for _, n in _profiler_uses(f.name)] == ["torch.autograd.profiler.profile",
                                                          "torch.autograd.profiler"]
    finally:
        os.unlink(f.name)
