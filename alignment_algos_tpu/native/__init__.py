"""Native helpers: the shared build_native() loader for the host-runtime
C/C++ engines, plus libm-exact elementwise math (see exactmath.c).

Shared objects are built on first use with the system compiler and cached
next to the sources under a CONTENT-HASHED name (`_<name>-<sha1[:12]>.so`).
Hashing the sources + flags into the file name makes staleness detection
exact: a leftover .so built from older sources can never be picked up (a
lesson learned — mtime comparisons are useless after `git checkout`, which
stamps every file with the same time, and a stale engine once shipped a
segfault).  Callers fall back to their Python/numpy paths when no compiler
is available.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "exactmath.c")


def build_native(name: str, srcs: list[str], flags: tuple = (),
                 libs: tuple = (), compiler: str | None = None):
    """Compile srcs into a content-hash-named .so and dlopen it.

    Returns the ctypes.CDLL, or None when the compiler is missing or the
    build fails (callers use their Python fallbacks).  The build is atomic
    (tmp + rename) so concurrent test processes can race safely, and the
    hash covers source bytes + flags so any edit forces a rebuild."""
    flags = tuple(flags) or ("-O2", "-ffp-contract=off")
    h = hashlib.sha1()
    try:
        for s in srcs:
            with open(s, "rb") as f:
                h.update(f.read())
    except OSError:
        return None
    h.update(" ".join(flags + tuple(libs)).encode())
    tag = h.hexdigest()[:12]
    cc = compiler or ("cc" if all(s.endswith(".c") for s in srcs) else "c++")
    # fallback cache is per-user with 0700 perms, NOT the shared tempdir:
    # a world-writable /tmp would let another user pre-plant the
    # predictably-named .so and get code loaded into this process
    user_cache = os.path.join(
        os.environ.get("XDG_CACHE_HOME")
        or os.path.join(os.path.expanduser("~"), ".cache"), "aat_native")
    for outdir in (_DIR, user_cache):
        if outdir is user_cache:
            try:
                os.makedirs(user_cache, mode=0o700, exist_ok=True)
                if os.stat(user_cache).st_uid != os.getuid():
                    continue
            except OSError:
                continue
        so = os.path.join(outdir, f"_{name}-{tag}.so")
        if os.path.exists(so):
            st = os.stat(so)
            if st.st_uid != os.getuid() or (st.st_mode & 0o022):
                continue  # not ours / group-or-world writable: refuse
        if not os.path.exists(so):
            tmp = f"{so}.tmp.{os.getpid()}"
            try:
                subprocess.run(
                    [cc, *flags, "-shared", "-fPIC", "-o", tmp, *srcs, *libs],
                    check=True, capture_output=True)
                os.replace(tmp, so)
            except (OSError, subprocess.CalledProcessError):
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                continue
        try:
            return ctypes.CDLL(so)
        except OSError:
            continue
    return None


_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    _lib = build_native("exactmath", [_SRC], flags=("-O2",), libs=("-lm",),
                        compiler="cc")
    return _lib


def _vec_f32(fn_name: str, np_fallback):
    def apply(x: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(x, dtype=np.float32)
        lib = _load()
        if lib is None:
            return np_fallback(x).astype(np.float32)
        y = np.empty_like(x)
        getattr(lib, fn_name)(
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_long(x.size))
        return y
    return apply


def _vec_f64(fn_name: str, np_fallback):
    def apply(x: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(x, dtype=np.float64)
        lib = _load()
        if lib is None:
            return np_fallback(x)
        y = np.empty_like(x)
        getattr(lib, fn_name)(
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            y.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.c_long(x.size))
        return y
    return apply


expf = _vec_f32("v_expf", np.exp)
logf = _vec_f32("v_logf", np.log)
sqrtf = _vec_f32("v_sqrtf", np.sqrt)
erfcf = _vec_f32("v_erfcf", lambda x: np.vectorize(__import__("math").erfc)(x))
exp64 = _vec_f64("v_exp", np.exp)
log64 = _vec_f64("v_log", np.log)
erfc64 = _vec_f64("v_erfc", lambda x: np.vectorize(__import__("math").erfc)(x))
