"""Build the CUDA sources in csrc/ with nvcc and load them with ctypes.

Each csrc/<name>.cu exports a plain C function and compiles into its own
shared library, self6dpp_tpu_torch/_build/lib<name>-<hash>.so, where <hash>
covers the source and the flags: a library is built once per content and
reused. nvcc's output, with ptxas' resource lines (-Xptxas -v), is kept
beside it as lib<name>-<hash>.log; resources() reads each kernel's
registers, static shared memory and spills from there. The host routines,
csrc/<name>.c, build the same way with the host C compiler (load_host).
Build at first use, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

# sm_90a: Hopper with its architecture-specific instructions. --fmad=false:
# no multiply-add contraction, so the kernels round as PyTorch's separate
# elementwise operations do (see csrc/fine_raster_fwd.cu). -Xptxas -v: each
# kernel's registers, shared memory and spills, for resources().
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v")


def nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda)")


# the host routines (csrc/*.c): plain C, no GPU
CC_FLAGS = ("-O3", "-std=c11", "-shared", "-fPIC")
# per-source additions: the FPS must round as numpy does (no multiply-add
# contraction; -std=c11 implies it under gcc, stated anyway)
CC_EXTRA = {"fps": ("-ffp-contract=off",)}


def _lib_path(name: str, ext: str = ".cu", flags=NVCC_FLAGS) -> Path:
    src = (SRC_DIR / f"{name}{ext}").read_bytes()
    h = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


def build_all(names: list[str] | None = None) -> dict[str, Path]:
    """Compile every named source (default: all of csrc/*.cu) that has no
    library for its content yet, one nvcc per source, all started together.
    Returns {name: library path}. Raises with nvcc's output on failure."""
    if names is None:
        names = sorted(p.stem for p in SRC_DIR.glob("*.cu"))
    exe = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {n: _lib_path(n) for n in names}
    procs = {}
    for n, lib in libs.items():
        if lib.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [exe, *NVCC_FLAGS, "-o", tmp, str(SRC_DIR / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    errors = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed on {n}.cu ({proc.returncode}):\n{out}")
        else:
            libs[n].with_suffix(".log").write_text(out)
            os.replace(tmp, libs[n])     # atomic: no half-written library
    if errors:
        raise RuntimeError("\n".join(errors))
    return libs


def _kernel_name(mangled: str) -> str:
    """The unqualified name of an Itanium-mangled function
    ('_ZN12_GLOBAL__N_17kernelEPKf' -> 'kernel'); the input if unmangled."""
    if not mangled.startswith("_Z"):
        return mangled
    rest, last = mangled[2:], mangled
    rest = rest[1:] if rest.startswith("N") else rest
    while n := re.match(r"\d+", rest):
        k, size = len(n.group()), int(n.group())
        last, rest = rest[k:k + size], rest[k + size:]
    return last


def resources(name: str) -> dict[str, dict[str, int]]:
    """Per kernel of csrc/<name>.cu, what ptxas reported when it was built:
    {kernel: {registers, smem_static_bytes, stack_bytes, spill_store_bytes,
    spill_load_bytes}}. Dynamic shared memory is set at launch and is not
    in it. Empty when the library was built without its log."""
    log = _lib_path(name).with_suffix(".log")
    if not log.exists():
        return {}
    out, cur = {}, None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(_kernel_name(m.group(1)), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            cur.update(registers=int(m.group(1)),
                       smem_static_bytes=int(smem.group(1)) if smem else 0)
    return out


def host_cc() -> str:
    """The host C compiler: $CC, else cc, gcc or clang on PATH."""
    for cc in (os.environ.get("CC"), "cc", "gcc", "clang"):
        found = cc and shutil.which(cc)
        if found:
            return found
    raise RuntimeError("no host C compiler ($CC, cc, gcc, clang)")


def load_host(name: str) -> ctypes.CDLL:
    """The library of the host routine csrc/<name>.c, built first (once per
    content) with the host C compiler, CC_FLAGS and the source's CC_EXTRA.
    Raises with the compiler's output on failure."""
    flags = CC_FLAGS + CC_EXTRA.get(name, ())
    lib = _lib_path(name, ".c", flags)
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        res = subprocess.run([host_cc(), *flags, "-o", tmp,
                              str(SRC_DIR / f"{name}.c")],
                             capture_output=True, text=True)
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"cc failed on {name}.c ({res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, lib)             # atomic: no half-written library
    return ctypes.CDLL(str(lib))


def load(name: str) -> ctypes.CDLL:
    """The library of csrc/<name>.cu, built first if needed. The caller keeps
    the handle (and sets the function's argtypes) once."""
    return ctypes.CDLL(str(build_all([name])[name]))
