"""Build the port's C API (``native/``): ``libiht.so`` and the standalone C
front-end ``iht_smoke``, the targets of the JAX package's
native/CMakeLists.txt, with the host compiler alone (no cmake).

    from ice_halo_sim_tpu_torch.kernels import capi
    paths = capi.build()        # {"lib": .../libiht.so, "smoke": .../iht_smoke}

Both go to ``ice_halo_sim_tpu_torch/_build/native/`` (listed in .gitignore)
at first use; a target is built again when one of its sources is newer. The
flags are CMake's: C++17 for the library, ``-fPIC``, ``-Wall -Wextra``, the
library linked into the smoke program (found through its rpath). The
embedded interpreter's include directory and library come from
``sysconfig`` of the running Python (``-lpython3.12`` and an rpath to its
directory where the library is shared).

The library embeds or joins CPython and drives
``ice_halo_sim_tpu_torch.engine.server.Server``; the Server runs on the
device that IHT_PLATFORM names ("cpu" or "cuda", "cuda" when unset).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sysconfig

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(_PKG, "native")
OUT_DIR = os.path.join(_PKG, "_build", "native")

LIB_SOURCES = ["src/c_api.cpp", "src/scene_builder.cpp", "include/iht.h"]
SMOKE_SOURCES = ["examples/smoke.c", "include/iht.h"]


def _python_link() -> list:
    """Link flags of the embedded interpreter."""
    libdir = sysconfig.get_config_var("LIBDIR")
    ver = sysconfig.get_config_var("LDVERSION") or sysconfig.get_config_var("VERSION")
    if not sysconfig.get_config_var("Py_ENABLE_SHARED"):
        raise RuntimeError("the C API embeds CPython from its shared library, and this "
                           "Python was built without one (Py_ENABLE_SHARED = 0)")
    return [f"-L{libdir}", f"-lpython{ver}", f"-Wl,-rpath,{libdir}"]


def _stale(target: str, sources: list) -> bool:
    if not os.path.exists(target):
        return True
    t = os.path.getmtime(target)
    return any(os.path.getmtime(os.path.join(NATIVE, s)) > t for s in sources)


def _compile(cmd: list, target: str) -> None:
    """Run a compiler command that writes `target`, through a temporary
    file renamed into place (a failed build leaves no target)."""
    tmp = f"{target}.tmp{os.getpid()}"
    res = subprocess.run(cmd + ["-o", tmp], capture_output=True, text=True, cwd=NATIVE)
    if res.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"{' '.join(cmd)} failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, target)


def build() -> dict:
    """Build what is missing or stale; the paths of both targets."""
    cxx = shutil.which("g++") or shutil.which("c++")
    cc = shutil.which("gcc") or shutil.which("cc")
    if cxx is None or cc is None:
        raise RuntimeError("the C API needs a host C and C++ compiler (g++, gcc)")
    os.makedirs(OUT_DIR, exist_ok=True)
    lib = os.path.join(OUT_DIR, "libiht.so")
    smoke = os.path.join(OUT_DIR, "iht_smoke")
    warn = ["-Wall", "-Wextra"]
    if _stale(lib, LIB_SOURCES):
        _compile([cxx, "-std=c++17", "-fPIC", "-shared", "-O2", *warn, "-Iinclude",
                  f"-I{sysconfig.get_config_var('INCLUDEPY')}",
                  "src/c_api.cpp", "src/scene_builder.cpp", *_python_link()], lib)
    if _stale(smoke, SMOKE_SOURCES) or os.path.getmtime(smoke) < os.path.getmtime(lib):
        _compile([cc, "-fPIC", "-O2", *warn, "-Iinclude", "examples/smoke.c",
                  f"-L{OUT_DIR}", "-liht", f"-Wl,-rpath,{OUT_DIR}"], smoke)
    return {"lib": lib, "smoke": smoke}
