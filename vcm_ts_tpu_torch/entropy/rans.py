"""Host-side rANS entropy coder bindings.

Loads the native C++ library (vcm_ts_tpu_torch/entropy/native/rans.cpp), building it
on first use with g++. If the toolchain is unavailable, falls back to a pure
Python implementation of the exact same bitstream format so the framework
remains functional (slowly) everywhere.

API parity with the reference's MLCodec_rans / MLCodec_CXX modules
(reference: DCVC_HEM/src/cpp/rans/rans_interface.cpp:246-261,
 DCVC_HEM/src/cpp/ops/ops.cpp:84-91): `BufferedRansEncoder`, `RansDecoder`,
`pmf_to_quantized_cdf`.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "build", "libvcm_rans.so")

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def _load_native():
    """Load (building if necessary) the native library. Returns None on failure."""
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SO_PATH):
            # build into a per-process directory, then rename: several test
            # workers may import this module at once, and none may load a
            # half-written library
            tmp_dir = os.path.join(_NATIVE_DIR, "build", f"tmp{os.getpid()}")
            try:
                subprocess.run(
                    ["make", "-C", _NATIVE_DIR, f"BUILD_DIR={tmp_dir}"],
                    check=True,
                    capture_output=True,
                    timeout=120,
                )
                os.replace(os.path.join(tmp_dir, "libvcm_rans.so"), _SO_PATH)
                os.rmdir(tmp_dir)
            except (OSError, subprocess.SubprocessError):
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:
            _build_failed = True
            return None

        i64 = ctypes.c_int64
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        vp = ctypes.c_void_p

        lib.vcm_rans_enc_create.restype = vp
        lib.vcm_rans_enc_destroy.argtypes = [vp]
        lib.vcm_rans_enc_reset.argtypes = [vp]
        lib.vcm_rans_enc_encode_with_indexes.argtypes = [
            vp, i32p, i32p, i64, i32p, i64, i32p, i32p]
        lib.vcm_rans_enc_flush_bound.argtypes = [vp]
        lib.vcm_rans_enc_flush_bound.restype = i64
        lib.vcm_rans_enc_flush.argtypes = [vp, u8p, i64]
        lib.vcm_rans_enc_flush.restype = i64

        lib.vcm_rans_dec_create.restype = vp
        lib.vcm_rans_dec_destroy.argtypes = [vp]
        lib.vcm_rans_dec_set_stream.argtypes = [vp, u8p, i64]
        lib.vcm_rans_dec_decode_stream.argtypes = [
            vp, i32p, i64, i32p, i64, i32p, i32p, i32p]

        lib.vcm_pmf_to_quantized_cdf.argtypes = [f32p, i64, ctypes.c_int32, u32p]
        lib.vcm_pmf_to_quantized_cdf.restype = ctypes.c_int32

        _lib = lib
        return _lib


def native_available() -> bool:
    return _load_native() is not None


def _as_i32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a).reshape(-1), dtype=np.int32)


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


# =============================================================================
# Pure-Python fallback (same bitstream format; see rans.cpp for the spec)
# =============================================================================

_RANS64_L = 1 << 31
_PROB_BITS = 16
_BYPASS_BITS = 4
_MAX_BYPASS = (1 << _BYPASS_BITS) - 1
_MASK64 = (1 << 64) - 1


class _PyEncoder:
    def __init__(self):
        self._syms = []  # (start, range, bypass)

    def reset(self):
        self._syms.clear()

    def encode_with_indexes(self, symbols, indexes, cdfs, cdf_sizes, offsets):
        symbols = _as_i32(symbols)
        indexes = _as_i32(indexes)
        cdfs = np.asarray(cdfs, dtype=np.int32)
        cdf_sizes = _as_i32(cdf_sizes)
        offsets = _as_i32(offsets)
        syms = self._syms
        for sym, idx in zip(symbols.tolist(), indexes.tolist()):
            cdf = cdfs[idx]
            max_value = int(cdf_sizes[idx]) - 2
            value = sym - int(offsets[idx])
            raw_val = 0
            if value < 0:
                raw_val = -2 * value - 1
                value = max_value
            elif value >= max_value:
                raw_val = 2 * (value - max_value)
                value = max_value
            syms.append((int(cdf[value]), int(cdf[value + 1] - cdf[value]), False))
            if value == max_value:
                n_bypass = 0
                while (raw_val >> (n_bypass * _BYPASS_BITS)) != 0:
                    n_bypass += 1
                val = n_bypass
                while val >= _MAX_BYPASS:
                    syms.append((_MAX_BYPASS, _MAX_BYPASS + 1, True))
                    val -= _MAX_BYPASS
                syms.append((val, val + 1, True))
                for j in range(n_bypass):
                    chunk = (raw_val >> (j * _BYPASS_BITS)) & _MAX_BYPASS
                    syms.append((chunk, chunk + 1, True))

    def flush(self) -> bytes:
        x = _RANS64_L
        words = []
        for start, rng, bypass in reversed(self._syms):
            if not bypass:
                x_max = ((_RANS64_L >> _PROB_BITS) << 32) * rng
                if x >= x_max:
                    words.append(x & 0xFFFFFFFF)
                    x >>= 32
                x = ((x // rng) << _PROB_BITS) + (x % rng) + start
            else:
                freq = 1 << (16 - _BYPASS_BITS)
                x_max = ((_RANS64_L >> 16) << 32) * freq
                if x >= x_max:
                    words.append(x & 0xFFFFFFFF)
                    x >>= 32
                x = ((x << _BYPASS_BITS) | start) & _MASK64
        words.append(x >> 32)
        words.append(x & 0xFFFFFFFF)
        words.reverse()
        return np.asarray(words, dtype=np.uint32).tobytes()


class _PyDecoder:
    def __init__(self):
        self._words = None
        self._pos = 0
        self._x = 0

    def set_stream(self, stream: bytes):
        self._words = np.frombuffer(stream, dtype=np.uint32)
        self._x = int(self._words[0]) | (int(self._words[1]) << 32)
        self._pos = 2

    def _get_bits(self, nbits):
        val = self._x & ((1 << nbits) - 1)
        self._x >>= nbits
        if self._x < _RANS64_L:
            self._x = (self._x << 32) | int(self._words[self._pos])
            self._pos += 1
        return val

    def decode_stream(self, indexes, cdfs, cdf_sizes, offsets):
        indexes = _as_i32(indexes)
        cdfs = np.asarray(cdfs, dtype=np.int32)
        cdf_sizes = _as_i32(cdf_sizes)
        offsets = _as_i32(offsets)
        out = np.empty(indexes.size, dtype=np.int32)
        mask = (1 << _PROB_BITS) - 1
        for i, idx in enumerate(indexes.tolist()):
            cdf = cdfs[idx]
            size = int(cdf_sizes[idx])
            max_value = size - 2
            cum = self._x & mask
            value = int(np.searchsorted(cdf[:size], cum, side="right")) - 1
            start = int(cdf[value])
            freq = int(cdf[value + 1]) - start
            self._x = freq * (self._x >> _PROB_BITS) + cum - start
            if self._x < _RANS64_L:
                self._x = (self._x << 32) | int(self._words[self._pos])
                self._pos += 1
            if value == max_value:
                val = self._get_bits(_BYPASS_BITS)
                n_bypass = val
                while val == _MAX_BYPASS:
                    val = self._get_bits(_BYPASS_BITS)
                    n_bypass += val
                raw_val = 0
                for j in range(n_bypass):
                    raw_val |= self._get_bits(_BYPASS_BITS) << (j * _BYPASS_BITS)
                value = raw_val >> 1
                if raw_val & 1:
                    value = -value - 1
                else:
                    value += max_value
            out[i] = value + int(offsets[idx])
        return out


def _py_pmf_to_quantized_cdf(pmf: np.ndarray, precision: int) -> np.ndarray:
    pmf = np.asarray(pmf, dtype=np.float32).reshape(-1)
    n = pmf.size
    cdf = np.zeros(n + 1, dtype=np.uint64)
    cdf[1:] = np.floor(np.maximum(pmf, 0.0).astype(np.float32)
                       * np.float32(1 << precision) + 0.5).astype(np.uint64)
    total = int(cdf.sum())
    if total == 0:
        out = ((1 << precision) * np.arange(n + 1, dtype=np.uint64)) // n
        out[-1] = 1 << precision
        return out.astype(np.int32)
    cdf = ((1 << precision) * cdf) // total
    cdf = np.cumsum(cdf)
    cdf[-1] = 1 << precision
    cdf = cdf.astype(np.int64)
    for i in range(n):
        if cdf[i] == cdf[i + 1]:
            freqs = cdf[1:] - cdf[:-1]
            candidates = np.where(freqs > 1)[0]
            if candidates.size == 0:
                raise ValueError("cannot build CDF: no frequency to steal")
            best_steal = candidates[np.argmin(freqs[candidates])]
            if best_steal < i:
                cdf[best_steal + 1:i + 1] -= 1
            else:
                cdf[i + 1:best_steal + 1] += 1
    return cdf.astype(np.int32)


# =============================================================================
# Public API
# =============================================================================


class BufferedRansEncoder:
    """Buffers (symbol, index) pairs and emits the rANS stream on flush().

    Reference parity: MLCodec_rans.BufferedRansEncoder
    (rans_interface.cpp:246-255).
    """

    def __init__(self):
        lib = _load_native()
        if lib is not None:
            self._lib = lib
            self._h = lib.vcm_rans_enc_create()
            self._py = None
        else:
            self._lib = None
            self._h = None
            self._py = _PyEncoder()

    def __del__(self):
        if getattr(self, "_lib", None) is not None and self._h:
            self._lib.vcm_rans_enc_destroy(self._h)
            self._h = None

    def reset(self):
        if self._py is not None:
            self._py.reset()
        else:
            self._lib.vcm_rans_enc_reset(self._h)

    def encode_with_indexes(self, symbols, indexes, cdfs, cdf_sizes, offsets):
        if self._py is not None:
            self._py.encode_with_indexes(symbols, indexes, cdfs, cdf_sizes, offsets)
            return
        symbols = _as_i32(symbols)
        indexes = _as_i32(indexes)
        cdfs = np.ascontiguousarray(np.asarray(cdfs), dtype=np.int32)
        cdf_sizes = _as_i32(cdf_sizes)
        offsets = _as_i32(offsets)
        assert cdfs.ndim == 2
        self._lib.vcm_rans_enc_encode_with_indexes(
            self._h, _i32p(symbols), _i32p(indexes), symbols.size,
            _i32p(cdfs.reshape(-1)), cdfs.shape[1], _i32p(cdf_sizes),
            _i32p(offsets))

    def flush(self) -> bytes:
        if self._py is not None:
            return self._py.flush()
        cap = self._lib.vcm_rans_enc_flush_bound(self._h)
        buf = np.empty(cap, dtype=np.uint8)
        n = self._lib.vcm_rans_enc_flush(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
        if n < 0:
            raise RuntimeError("rANS flush buffer overflow")
        return buf[:n].tobytes()


class RansDecoder:
    """Sequential rANS stream decoder.

    Reference parity: MLCodec_rans.RansDecoder (rans_interface.cpp:257-260).
    """

    def __init__(self):
        lib = _load_native()
        if lib is not None:
            self._lib = lib
            self._h = lib.vcm_rans_dec_create()
            self._py = None
        else:
            self._lib = None
            self._h = None
            self._py = _PyDecoder()

    def __del__(self):
        if getattr(self, "_lib", None) is not None and self._h:
            self._lib.vcm_rans_dec_destroy(self._h)
            self._h = None

    def set_stream(self, stream: bytes):
        if self._py is not None:
            self._py.set_stream(stream)
            return
        buf = np.frombuffer(stream, dtype=np.uint8)
        buf = np.ascontiguousarray(buf)
        self._stream_keepalive = buf  # keep stream memory alive during decode
        self._lib.vcm_rans_dec_set_stream(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.size)

    def decode_stream(self, indexes, cdfs, cdf_sizes, offsets) -> np.ndarray:
        if self._py is not None:
            return self._py.decode_stream(indexes, cdfs, cdf_sizes, offsets)
        indexes = _as_i32(indexes)
        cdfs = np.ascontiguousarray(np.asarray(cdfs), dtype=np.int32)
        cdf_sizes = _as_i32(cdf_sizes)
        offsets = _as_i32(offsets)
        out = np.empty(indexes.size, dtype=np.int32)
        self._lib.vcm_rans_dec_decode_stream(
            self._h, _i32p(indexes), indexes.size, _i32p(cdfs.reshape(-1)),
            cdfs.shape[1], _i32p(cdf_sizes), _i32p(offsets), _i32p(out))
        return out


def pmf_to_quantized_cdf(pmf, precision: int = 16) -> np.ndarray:
    """Quantize a PMF to an integer CDF with minimum frequency 1 per symbol.

    Reference parity: MLCodec_CXX.pmf_to_quantized_cdf (ops.cpp:24-82).
    """
    pmf = np.ascontiguousarray(np.asarray(pmf, dtype=np.float32).reshape(-1))
    lib = _load_native()
    if lib is None:
        return _py_pmf_to_quantized_cdf(pmf, precision)
    out = np.empty(pmf.size + 1, dtype=np.uint32)
    rc = lib.vcm_pmf_to_quantized_cdf(
        pmf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), pmf.size,
        precision, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    if rc != 0:
        raise ValueError(f"pmf_to_quantized_cdf failed with code {rc}")
    return out.astype(np.int32)
