"""ctypes bindings for the port's native host IO core (`avtubes_io.cc`).

The port's own copy of the JAX package's native core: threaded WAV decode +
preparation, JPEG decode with a PIL-compatible shortest-side bicubic resize
(optionally with libjpeg's DCT-domain scaling), the fused training-clip
decode and the int16 host log-spectrogram, in a C++ thread pool that runs
past the GIL.  Every entry point keeps the JAX package's name, signature and
semantics, and the source is built with the same flags, so both libraries
give bit-equal outputs on the same files.

The library is built with `g++` at first use (never at import) into
`avtubes_torch/_build/libavtubes_torch_io-<hash>.so` (the hash covers the
source, the Makefile and the libjpeg route), under a cross-process file
lock, through a temporary file and an atomic rename.  libjpeg comes from one
of two routes, tried in order:

  * ``system``: the build host's own `jpeglib.h` and `-ljpeg`;
  * ``pillow``: the vendored ABI-62 headers in `include/` and the libjpeg
    that Pillow's wheel bundles (`pillow.libs/libjpeg-*.so.62*`), found from
    where PIL is installed and linked with an rpath.

Where neither builds, every caller takes its Python path (PIL, numpy) and
one line on stderr says why: this is host decode, not a device kernel.  Set
AVTUBES_TORCH_NO_NATIVE=1 to force the Python paths (A/B parity runs,
debugging a decode discrepancy); it is read at every call and is the port's
own switch, independent of the JAX package's AVTUBES_NO_NATIVE.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "avtubes_io.cc"
BUILD_DIR = _DIR.parent / "_build"
KILL_SWITCH = "AVTUBES_TORCH_NO_NATIVE"

_lock = threading.Lock()
_lib = None
_tried = False
_info: dict = {}
_said: set[str] = set()


def shortest_side_dims(h: int, w: int, target: int) -> tuple[int, int]:
    """(rh, rw) of a shortest-side resize to `target`.  Python round() is
    half-to-even, matching the C++ side's std::nearbyint (`shortest_dims`
    in avtubes_io.cc) — the two copies MUST stay in lockstep or buffer
    sizes disagree at exact .5 ties (tests/test_torch_port_native.py pins a
    tie)."""
    if w < h:
        return max(1, round(h * target / w)), target
    return target, max(1, round(w * target / h))


def _say(why: str) -> None:
    """One line on stderr per reason and process."""
    if why not in _said:
        _said.add(why)
        print(f"[avtubes_torch.native] {why}; using the Python IO paths",
              file=sys.stderr, flush=True)


def disabled() -> bool:
    """True while AVTUBES_TORCH_NO_NATIVE forces the Python paths."""
    return os.environ.get(KILL_SWITCH, "") not in ("", "0")


def pillow_libjpeg() -> Path | None:
    """The ABI-62 libjpeg bundled in Pillow's wheel, found without importing
    PIL; None where Pillow links a system libjpeg or is absent."""
    import importlib.util

    spec = importlib.util.find_spec("PIL")
    if spec is None or not spec.origin:
        return None
    found = sorted((Path(spec.origin).parent.parent / "pillow.libs").glob("libjpeg-*.so.62*"))
    return found[0] if found else None


def _routes() -> list[tuple[str, str, str]]:
    """(route, JPEG_CFLAGS, JPEG_LIBS) in the order they are tried."""
    routes = [("system", "", "-ljpeg")]
    lib = pillow_libjpeg()
    if lib is not None:
        routes.append(("pillow", f"-I{_DIR / 'include'}",
                       f"{lib} -Wl,-rpath,{lib.parent}"))
    return routes


def library_path(route: str, cflags: str, libs: str) -> Path:
    """Where the library of the current source, built by `route`, lives."""
    h = hashlib.sha256()
    for part in (_SRC.read_bytes(), (_DIR / "Makefile").read_bytes(),
                 route.encode(), cflags.encode(), libs.encode()):
        h.update(part)
    return BUILD_DIR / f"libavtubes_torch_io-{h.hexdigest()[:16]}.so"


def _load() -> tuple[ctypes.CDLL, dict] | None:
    """Build (where missing) and load the library by the first route that
    works: (handle, how it was made), or None with the reason said.  A
    library that fails to load (its libjpeg is not on this machine) counts
    as a route that did not work."""
    import fcntl

    errors = []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # the file lock serialises builders across processes (test workers,
    # multi-process trainers); the Makefile's temp + rename keeps even an
    # unlocked reader from mapping a half-written file
    with open(BUILD_DIR / ".native.lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        for route, cflags, libs in _routes():
            out = library_path(route, cflags, libs)
            seconds = 0.0
            if not out.exists():
                t0 = time.monotonic()
                try:
                    subprocess.run(["make", "-s", "-C", str(_DIR), f"OUT={out}",
                                    f"JPEG_CFLAGS={cflags}", f"JPEG_LIBS={libs}"],
                                   check=True, capture_output=True, text=True, timeout=300)
                except subprocess.CalledProcessError as e:
                    last = (e.stderr or e.stdout or "").strip().splitlines()
                    errors.append(f"{route}: {last[-1] if last else e}")
                    continue
                except (OSError, subprocess.TimeoutExpired) as e:
                    errors.append(f"{route}: {e}")
                    continue
                seconds = time.monotonic() - t0
            try:
                lib = ctypes.CDLL(str(out))
                _bind(lib)
            except (OSError, AttributeError) as e:
                errors.append(f"{route}: {e}")
                continue
            return lib, {"route": route, "library": out.name, "build_seconds": seconds}
    _say("native IO core did not build or load (" + "; ".join(errors) + ")")
    return None


def get_lib():
    """Load (building if needed) the native library, or None if unavailable."""
    global _lib, _tried
    if disabled():
        _say(f"{KILL_SWITCH} is set")
        return None
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        loaded = _load()
        if loaded is not None:
            _lib, info = loaded
            _info.update(info)
        return _lib


def build_info() -> dict:
    """How the loaded library was made: its route, file, build seconds (0.0
    when it was already built) and the libjpeg headers it was compiled
    against (`JPEG_LIB_VERSION` / `LIBJPEG_TURBO_VERSION`).  Builds the
    library first; an empty dict when it is unavailable."""
    if get_lib() is None:
        return {}
    info = dict(_info)
    cflags = dict((r, c) for r, c, _ in _routes()).get(info["route"], "")
    probe = subprocess.run(
        ["g++", "-E", "-dM", "-x", "c++", *cflags.split(), "-"],
        input="#include <cstdio>\n#include <jpeglib.h>\n", text=True,
        capture_output=True, timeout=60)
    macros = dict(ln.split()[1:3] for ln in probe.stdout.splitlines()
                  if ln.startswith(("#define JPEG_LIB_VERSION ",
                                    "#define LIBJPEG_TURBO_VERSION ")))
    info["jpeg_lib_version"] = macros.get("JPEG_LIB_VERSION")
    info["libjpeg_turbo_headers"] = macros.get("LIBJPEG_TURBO_VERSION")
    if info["route"] == "pillow":
        info["linked"] = str(pillow_libjpeg())
    return info


def _bind(lib) -> None:
    lib.avt_decode_wav.restype = ctypes.c_int
    lib.avt_decode_wav.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.avt_decode_wav_batch.restype = None
    lib.avt_decode_wav_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.avt_jpeg_size.restype = ctypes.c_int
    lib.avt_jpeg_size.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.avt_decode_jpeg.restype = ctypes.c_int
    lib.avt_decode_jpeg.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int]
    lib.avt_decode_jpeg_shortest.restype = ctypes.c_int
    lib.avt_decode_jpeg_shortest.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int]
    lib.avt_decode_jpeg_shortest_mem.restype = ctypes.c_int
    lib.avt_decode_jpeg_shortest_mem.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,  # c_char_p: zero-copy bytes pass
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int]
    lib.avt_decode_jpeg_shortest_batch.restype = None
    lib.avt_decode_jpeg_shortest_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int]
    lib.avt_decode_jpeg_batch.restype = None
    lib.avt_decode_jpeg_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.avt_decode_clip_train.restype = ctypes.c_int
    lib.avt_decode_clip_train.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int]
    lib.avt_log_spec_i16.restype = ctypes.c_int
    lib.avt_log_spec_i16.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int16)]
    lib.avt_decode_wav_spec_batch.restype = None
    lib.avt_decode_wav_spec_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int]


def available() -> bool:
    return get_lib() is not None


def _paths(paths) -> ctypes.Array:
    return (ctypes.c_char_p * len(paths))(*[str(p).encode() for p in paths])


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _check_stft_shape(n_samples: int, nperseg: int, noverlap: int,
                      num_freqs: int, num_frames: int, what: str) -> None:
    """The C side derives the frame count from the waveform length and
    writes nperseg//2+1 rows: an output allocated for other counts would be
    overrun, so a mismatch (a caller bug) raises."""
    hop = nperseg - noverlap
    derived = (n_samples - nperseg) // hop + 1 if hop > 0 else -1
    if derived != num_frames:
        raise ValueError(
            f"{what} {n_samples} yields {derived} STFT frames, but the output "
            f"is allocated for {num_frames}; prepare the waveform to the "
            "configured num_samples first")
    if num_freqs != nperseg // 2 + 1:
        raise ValueError(
            f"the C side writes nperseg//2+1 = {nperseg // 2 + 1} frequency "
            f"rows, but the output is allocated for {num_freqs}")


def decode_wav_prepared(path: str | Path, seconds: int,
                        out_len: int) -> tuple[np.ndarray, int] | None:
    """Decode + prepare one WAV into a fixed float32 buffer; None on failure."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(out_len, np.float32)
    sr = lib.avt_decode_wav(str(path).encode(), seconds, _ptr(out, ctypes.c_float), out_len)
    if sr == 0:
        return None
    return out, sr


def decode_wav_batch(paths: list[str | Path], seconds: int, out_len: int,
                     threads: int = 8) -> tuple[np.ndarray, np.ndarray] | None:
    """Threaded batch decode+prepare -> ((n, out_len) float32, (n,) rates;
    rate 0 = failed)."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, out_len), np.float32)
    rates = np.zeros(n, np.int32)
    lib.avt_decode_wav_batch(_paths(paths), n, seconds, _ptr(out, ctypes.c_float),
                             out_len, _ptr(rates, ctypes.c_int), threads)
    return out, rates


def decode_clip_train(paths: list[str | Path], short_side: int, crop: int,
                      top: int, left: int, threads: int = 1,
                      scaled: bool = True) -> np.ndarray | None:
    """Fused training-clip decode: every frame -> decode + shortest-side
    bicubic resize + the SAME (top, left) crop window, one C++ call, output
    (n, crop, crop, 3) uint8.  None when the library is unavailable or any
    frame fails (the caller falls back to the per-frame path)."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, crop, crop, 3), np.uint8)
    good = lib.avt_decode_clip_train(_paths(paths), n, short_side, crop, top, left,
                                     _ptr(out, ctypes.c_uint8), threads, int(scaled))
    return out if good == n else None


def log_spectrogram_i16(wav: np.ndarray, samplerate: int, nperseg: int,
                        noverlap: int, num_freqs: int,
                        num_frames: int) -> np.ndarray | None:
    """Native log-spectrogram of a prepared f32 waveform -> (F, T) int16
    (the spec_int16 transport payload; scale SPEC_INT16_SCALE).  None when
    the library is unavailable or nperseg is not a power of two — callers
    take the numpy path (`log_spectrogram_np_f32` + quantize)."""
    lib = get_lib()
    if lib is None:
        return None
    wav = np.ascontiguousarray(wav, np.float32)
    _check_stft_shape(wav.shape[0], nperseg, noverlap, num_freqs, num_frames,
                      "waveform length")
    out = np.empty((num_freqs, num_frames), np.int16)
    ok = lib.avt_log_spec_i16(_ptr(wav, ctypes.c_float), wav.shape[0], samplerate,
                              nperseg, noverlap, _ptr(out, ctypes.c_int16))
    return out if ok else None


def decode_wav_spec_batch(paths: list[str | Path], seconds: int, wav_len: int,
                          samplerate: int, nperseg: int, noverlap: int,
                          num_freqs: int, num_frames: int, threads: int = 8
                          ) -> tuple[np.ndarray, np.ndarray] | None:
    """Fused threaded batch: WAV decode + prepare + log-spectrogram ->
    ((n, F, T) int16, (n,) rates; rate 0 = failed)."""
    lib = get_lib()
    if lib is None:
        return None
    _check_stft_shape(wav_len, nperseg, noverlap, num_freqs, num_frames, "wav_len")
    n = len(paths)
    out = np.empty((n, num_freqs, num_frames), np.int16)
    rates = np.zeros(n, np.int32)
    lib.avt_decode_wav_spec_batch(_paths(paths), n, seconds, wav_len, samplerate,
                                  nperseg, noverlap, _ptr(out, ctypes.c_int16),
                                  _ptr(rates, ctypes.c_int), threads)
    return out, rates


def jpeg_size(path: str | Path) -> tuple[int, int] | None:
    """(h, w) from a JPEG's header; None on failure."""
    lib = get_lib()
    if lib is None:
        return None
    h = ctypes.c_int()
    w = ctypes.c_int()
    if not lib.avt_jpeg_size(str(path).encode(), ctypes.byref(h), ctypes.byref(w)):
        return None
    return h.value, w.value


def decode_jpeg(path: str | Path) -> np.ndarray | None:
    """Decode one JPEG to (H, W, 3) RGB uint8; None on failure."""
    lib = get_lib()
    if lib is None:
        return None
    size = jpeg_size(path)
    if size is None:
        return None
    h, w = size
    if h * w > 100_000_000:  # untrusted header dims (same cap as the C++
        return None  # decode_jpeg_to guard): don't allocate gigabytes
    out = np.empty((h, w, 3), np.uint8)
    if not lib.avt_decode_jpeg(str(path).encode(), _ptr(out, ctypes.c_uint8), h, w):
        return None
    return out


def decode_jpeg_shortest(path: str | Path, short_side: int,
                         crop: int = 0, scaled: bool = True) -> np.ndarray | None:
    """Fused decode + PIL-compatible shortest-side bicubic resize
    (+ centre crop to (crop, crop) when crop > 0).  None on failure.

    scaled=True lets libjpeg's DCT-domain M/8 scaling do most of the
    downscale (pixel values drift ~2 levels from PIL bicubic — the PIL
    Image.draft tradeoff); scaled=False decodes at full resolution and is
    within one level of the PIL path.
    """
    lib = get_lib()
    if lib is None:
        return None
    if crop > 0:
        out = np.empty((crop, crop, 3), np.uint8)
    else:
        size = jpeg_size(path)
        if size is None:
            return None
        h, w = size
        rh, rw = shortest_side_dims(h, w, short_side)
        if h * w > 100_000_000 or rh * rw > 100_000_000:
            return None  # untrusted header dims / extreme aspect ratio
        out = np.empty((rh, rw, 3), np.uint8)
    oh = ctypes.c_int()
    ow = ctypes.c_int()
    if not lib.avt_decode_jpeg_shortest(
            str(path).encode(), short_side, crop, _ptr(out, ctypes.c_uint8),
            ctypes.byref(oh), ctypes.byref(ow), int(scaled)):
        return None
    return out


def decode_jpeg_shortest_bytes(data: bytes, short_side: int, crop: int,
                               scaled: bool = False) -> np.ndarray | None:
    """`decode_jpeg_shortest` over an IN-MEMORY JPEG (serving requests are
    bytes, not files) -> (crop, crop, 3) uint8, or None on failure, a
    non-JPEG payload or the library unavailable — callers take the PIL path,
    which computes the same transform (and reads PNG etc.).  crop > 0 is
    required: serving always centre-crops to the model's input size."""
    if crop <= 0:
        raise ValueError("decode_jpeg_shortest_bytes requires crop > 0")
    if len(data) < 3 or data[:3] != b"\xff\xd8\xff":  # not a JPEG (e.g. PNG)
        return None
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((crop, crop, 3), np.uint8)
    oh = ctypes.c_int()
    ow = ctypes.c_int()
    if not lib.avt_decode_jpeg_shortest_mem(
            data, len(data), short_side, crop, _ptr(out, ctypes.c_uint8),
            ctypes.byref(oh), ctypes.byref(ow), int(scaled)):
        return None
    return out


def decode_jpeg_shortest_batch(paths: list[str | Path], short_side: int,
                               crop: int, threads: int = 8, scaled: bool = True
                               ) -> tuple[np.ndarray, np.ndarray] | None:
    """Threaded fused decode+resize+centre-crop -> ((n,crop,crop,3), ok).

    crop must be > 0: the batch layout is (n, crop, crop, 3), so the
    variable-size crop==0 mode of the single-image call has no batch form.
    """
    if crop <= 0:
        raise ValueError("decode_jpeg_shortest_batch requires crop > 0 "
                         "(use decode_jpeg_shortest for variable-size output)")
    lib = get_lib()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, crop, crop, 3), np.uint8)
    ok = np.zeros(n, np.int32)
    lib.avt_decode_jpeg_shortest_batch(_paths(paths), n, short_side, crop,
                                       _ptr(out, ctypes.c_uint8), _ptr(ok, ctypes.c_int),
                                       threads, int(scaled))
    return out, ok


def decode_jpeg_batch(paths: list[str | Path], h: int, w: int,
                      threads: int = 8) -> tuple[np.ndarray, np.ndarray] | None:
    """Threaded decode of same-size JPEGs -> ((n,h,w,3) uint8, (n,) ok flags)."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, h, w, 3), np.uint8)
    ok = np.zeros(n, np.int32)
    lib.avt_decode_jpeg_batch(_paths(paths), n, _ptr(out, ctypes.c_uint8), h, w,
                              _ptr(ok, ctypes.c_int), threads)
    return out, ok
