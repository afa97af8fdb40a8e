"""Codec engines: run the models' stages around the host rANS coder.

Counterpart of the single-device part of vcm_ts_tpu/codec/engine.py
(`IntraCodec`, `VideoCodec`): `update`, `forward`, `compress`,
`compress_batch`, `decompress`, `decompress_batch`, `encode_gop`,
`decode_gop`, `encode_decode`. Between stages only int16 symbol planes and
uint8 scale-index planes cross to the host.

Spatial mode (`set_spatial_sharding`, the JAX engine's spatial sharding):
one stream's frames split by rows (H) over the ranks of a process group,
SPMD (every rank makes the same calls; parallel/spatial.py). Each rank
holds and computes its rows of every plane that tiles the group (the rest
whole); the convs exchange halo rows and the warps gather their images.
The host rANS is unchanged: every rank all-gathers the symbol and index
planes, runs the same coder and so writes, and reads, the same stream,
and uploads only its rows of each decoded plane. Frames given as host
(numpy) arrays are whole, and the engine takes this rank's rows; tensors
are taken as `spatial_shard_tree` gives them (this rank's rows). The
DPB, the recon and the decoded frames come back as this rank's rows
(parallel/spatial.gather_spatial joins them); heights and widths stay
global. One call at a time through a spatial codec: the ranks'
collectives must come in the same order.

The ENCODER derives every prior the stream depends on through the decoder's
own stage methods (plus encoder-only analysis), so encoder and decoder see
bit-identical priors on any frame chain. On the GPU that also needs cuDNN
to pick the same algorithm for the same conv every time:
`set_codec_numerics` fixes that (deterministic, no benchmark, no TF32), and
every symbol plane enters a stage in one canonical form (parameter dtype,
dense NHWC), whether it came from the encoder or from the stream.

Host and device overlap. The device's work is queued and the host waits
only where it needs a plane: each device->host transfer is a `_Pull` (all
of a frame's planes queued at once into pinned memory, one event behind
them), uploads do not wait, and nothing else on the stage path
synchronizes (the q scales and the index constants are made on the
device). `encode_gop` host-encodes frame t while frame t+1's chain runs;
the decoders host-decode a plane with static indexes while a stage runs
(the next stream's mv_z during stage 1 in `decode_gop`, z during stage
3a), and `decode_gop` keeps the DPB on the device.

Batches and sessions. `compress_batch` / `decompress_batch` carry N
independent streams through the batch axis of every stage, one rANS stream
per row, with per-row q scales (N, 1, 1, 1); the per-stream rANS work runs
on a thread pool (the native coder releases the GIL). The ops whose
libraries sum in an order that follows the batch size go row by row
(ops/rowwise.py), so each row's stream, DPB and recon are those of the
row coded alone, bit for bit. The engines keep no
mutable state across a call, so threads may run sessions through one
codec at once, each on its own CUDA stream: every launch goes on the
calling thread's current stream. A caller orders its stream after the work
that made its inputs (`stream.wait_stream`).
"""

from __future__ import annotations

import contextlib
import copy
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..entropy import bit_estimator as be
from ..entropy.coder import EntropyCoder
from ..entropy.gaussian import GaussianCoder
from ..models import common as cm
from ..ops.layers import SubpelConv
from ..parallel.spatial import map_tree, shard_spatial_model
from ..utils.device import resolve_device, set_codec_numerics, to_device
from . import bitstream as bs

MAX_RANS_THREADS = 8  # host threads of one batched call's rANS work


def _i16(x: torch.Tensor) -> torch.Tensor:
    """Symbol planes cross to the host as int16, saturated in f32 BEFORE
    the int cast (float->int of NaN or out-of-range values is undefined);
    NaN maps to 0."""
    xf = torch.nan_to_num(x.float(), nan=0.0, posinf=32767.0,
                          neginf=-32768.0)
    return torch.clamp(xf, -32768.0, 32767.0).to(torch.int16)


def param_dtype(model: torch.nn.Module) -> torch.dtype:
    """The dtype of the parameter whose flax path sorts first: the JAX
    engine's `tree_leaves(params)[0].dtype` (dict keys sorted at every
    level; the port's names are the flax paths with "kernel" named
    "weight"). Symbol planes and the DPB take this dtype."""
    def flax_path(name: str) -> tuple:
        parts = name.split(".")
        return (*parts[:-1], "kernel" if parts[-1] == "weight" else parts[-1])

    _, p = min(model.named_parameters(), key=lambda kv: flax_path(kv[0]))
    return p.dtype


class _Pull:
    """Device planes on their way to the host. Every plane's copy is queued
    at once (non-blocking, into pinned buffers of its own, so a pending
    pull is never overwritten) on the current stream, behind the work that
    makes it, and one event marks their end; `wait()` syncs on that event
    only and returns numpy arrays. On the CPU the planes are read as they
    are."""

    def __init__(self, planes: dict):
        self._host, self._event = planes, None
        dev = next(iter(planes.values())).device
        if dev.type == "cuda":
            self._host = {}
            for k, v in planes.items():
                self._host[k] = torch.empty(v.shape, dtype=v.dtype,
                                            pin_memory=True)
                self._host[k].copy_(v, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(dev))

    def wait(self) -> dict:
        if self._event is not None:
            self._event.synchronize()
        return {k: v.numpy() for k, v in self._host.items()}


def _rows(a: np.ndarray) -> list:
    """A batched plane's rows, each (1, ...)."""
    return [a[i:i + 1] for i in range(a.shape[0])]


def _pool(n: int):
    """A thread pool for the rANS work of n streams; none for one."""
    if n == 1:
        return contextlib.nullcontext()
    return ThreadPoolExecutor(min(n, MAX_RANS_THREADS))


def _map(pool, fn, items) -> list:
    return [fn(v) for v in items] if pool is None else list(
        pool.map(fn, items))


def _decoders(streams) -> list:
    coders = [EntropyCoder() for _ in streams]
    for coder, stream in zip(coders, streams):
        coder.set_stream(stream)
    return coders


def run_sessions(fns, device, warmup=None) -> tuple:
    """Run each callable in fns at once, each on its own thread and, on the
    card, its own CUDA stream, ordered after the default stream's work (the
    inputs') and synchronized at its end. `warmup()`, if given, first runs
    in every session's thread: PyTorch keeps cuDNN's execution plans per
    thread, so a new thread's first convs build them again. The clock
    starts once every session has warmed up. Returns (seconds from then to
    the last finish, the results in order)."""
    device = torch.device(device)
    start = threading.Barrier(len(fns) + 1)

    def session(fn):
        with torch.no_grad(), contextlib.ExitStack() as stack:
            stream = None
            if device.type == "cuda":
                stream = torch.cuda.Stream(device)
                stream.wait_stream(torch.cuda.default_stream(device))
                stack.enter_context(torch.cuda.stream(stream))
            try:
                if warmup is not None:
                    warmup()
                if stream is not None:
                    stream.synchronize()
            except BaseException:
                start.abort()
                raise
            start.wait()
            out = fn()
            if stream is not None:
                stream.synchronize()
            return out

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    with ThreadPoolExecutor(max_workers=len(fns)) as pool:
        futures = [pool.submit(session, fn) for fn in fns]
        try:
            start.wait()
        except threading.BrokenBarrierError:
            for f in futures:  # raise the warm-up's own error
                e = f.exception()
                if not (e is None or isinstance(e, threading.BrokenBarrierError)):
                    raise e from None
            raise
        t0 = time.perf_counter()
        results = [f.result() for f in futures]
        return time.perf_counter() - t0, results


def _on_streams(fns, streams) -> list:
    """fn() of each of fns at once, each on its own thread and, where its
    stream is a CUDA stream (None on the CPU), on that stream, ordered
    after the caller's current stream of its device and synchronized at
    its end; the results in order."""
    after = {s.device: torch.cuda.current_stream(s.device) for s in streams
             if s is not None}

    def run(fn, stream):
        with torch.no_grad(), contextlib.ExitStack() as stack:
            if stream is not None:
                stack.enter_context(torch.cuda.device(stream.device))
                stream.wait_stream(after[stream.device])
                stack.enter_context(torch.cuda.stream(stream))
            out = fn()
            if stream is not None:
                stream.synchronize()
            return out

    with ThreadPoolExecutor(max_workers=len(fns)) as pool:
        futures = [pool.submit(run, fn, s) for fn, s in zip(fns, streams)]
        return [f.result() for f in futures]


def _take(v, rows: slice, n: int, device):
    """Rows `rows` of a batched argument with n rows (a tensor, array, or
    a dict of them) on `device`; anything else (a float q scale, a flag)
    as it is."""
    if isinstance(v, dict):
        return {k: _take(x, rows, n, device) for k, x in v.items()}
    if isinstance(v, torch.Tensor) and v.dim() and v.shape[0] == n:
        return v[rows].to(device)
    if isinstance(v, list) and len(v) == n or (
            isinstance(v, np.ndarray) and v.ndim and v.shape[0] == n):
        return v[rows]
    return v


def _gather(parts: list, device):
    """The groups' results joined back in row order: tensors concatenated
    on `device` (a 0-dim total, as forward's "bit", summed), arrays and
    lists concatenated, dicts and tuples per entry."""
    first = parts[0]
    if isinstance(first, dict):
        return {k: _gather([p[k] for p in parts], device) for k in first}
    if isinstance(first, torch.Tensor):
        for p in parts:
            if p.is_cuda:  # made on a replica's stream, read on this one
                p.record_stream(torch.cuda.current_stream(p.device))
        parts = [p.to(device) for p in parts]
        return torch.stack(parts).sum(0) if not first.dim() else \
            torch.cat(parts)
    if isinstance(first, np.ndarray):
        return np.concatenate(parts)
    if isinstance(first, tuple):
        return tuple(_gather(list(p), device) for p in zip(*parts))
    if isinstance(first, list):
        return [x for p in parts for x in p]
    return first


class _Engine:
    """What both codecs share: device placement, numerics, symbol IO,
    fleet serving and spatial mode (module docstring).

    Fleet serving (`set_fleet_sharding`, the port's _FleetShardingMixin of
    the JAX engine): each batched call (compress_batch, decompress_batch,
    forward) splits its N stream rows into one group of N / D rows per
    device of the fleet. Each device holds a replica of the codec (its own
    copy of the model) and runs its group on its own thread and CUDA
    stream; host rANS stays per stream. Rows code as if alone
    (ops/rowwise.py), so every stream's bytes and recon equal the
    unsharded call's. A call whose N does not tile the fleet runs
    unsharded, as the JAX engine's shard_batch / _put leave such a
    leading dimension whole. Fleet and spatial mode exclude each other."""

    _TABLES = ("y_table", "z_table")
    _fleet = None
    _spatial = None  # the SpatialAxis of set_spatial_sharding

    def __init__(self, model, distribution: str, device):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_codec_numerics()
        self.model = model.to(self.device).eval()
        self.param_dtype = param_dtype(model)
        self.gaussian = GaussianCoder(distribution)
        self.y_table = None
        self.z_table = None
        # derive the cached k-major weights now, so that concurrent
        # sessions only read the model
        for m in self.model.modules():
            if isinstance(m, SubpelConv):
                m.kmajor_weights()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _check_tables(self):
        if self.z_table is None:
            raise RuntimeError("call update() first")

    def _sym_in(self, sym: torch.Tensor) -> torch.Tensor:
        """A symbol plane as a stage input: parameter dtype, dense NHWC."""
        return sym.to(self.param_dtype).contiguous()

    def _idx_u8(self, scales: torch.Tensor) -> torch.Tensor:
        return self.gaussian.build_indexes(scales).to(torch.uint8)

    def _up(self, symbols) -> torch.Tensor:
        """A whole host plane on the device (spatial mode: this rank's
        rows)."""
        t = torch.from_numpy(np.ascontiguousarray(symbols, dtype=np.int16))
        if self._spatial is not None:
            t = self._spatial.own_rows(t, 1)
        return to_device(t, self.device)

    def _frame(self, x) -> torch.Tensor:
        host = isinstance(x, np.ndarray)
        x = torch.as_tensor(x)
        if host and self._spatial is not None:
            x = self._spatial.own_rows(x, 1)
        x = to_device(x, self.device)
        return x.to(self.param_dtype).contiguous()

    def _frame_of(self, x):
        """Spatial mode: the context of a frame argument's size (a host
        array is whole, a tensor this rank's rows); else a no-op."""
        sp = self._spatial
        if sp is None:
            return contextlib.nullcontext()
        h = x.shape[1] if isinstance(x, np.ndarray) else sp.n * x.shape[1]
        return sp.frame(h, x.shape[2])

    def _sized(self, height: int, width: int):
        """Spatial mode: the context of a height x width frame."""
        sp = self._spatial
        return (contextlib.nullcontext() if sp is None
                else sp.frame(height, width))

    def _pull_planes(self, planes: dict) -> _Pull:
        """Queue device planes to the host, each whole (spatial mode:
        gathered where split)."""
        if self._spatial is not None:
            planes = {k: self._spatial.whole(v, 1) for k, v in planes.items()}
        return _Pull(planes)

    def _fetch(self, t: torch.Tensor) -> np.ndarray:
        """One device plane -> numpy (whole), waiting for it."""
        return self._pull_planes({"t": t}).wait()["t"]

    def _row0(self, t) -> int:
        return cm.plane_row0(self._spatial, t)

    def _sym0(self, y, means, q_step):
        return _i16(cm.encode_symbols_step0(y, means, q_step, self._row0(y)))

    def _sym1(self, y, means_0, means_1, q_step):
        return _i16(cm.encode_symbols_step1(y, means_0, means_1, q_step,
                                            self._row0(y)))

    @staticmethod
    def _read(pool, coders, indexes, table) -> np.ndarray:
        """One plane of every stream: coders[i] decodes with indexes[i].
        Returns the symbols stacked along N, as int16."""
        planes = _map(pool, lambda ci: np.asarray(
            ci[0].decode_stream(ci[1], table), np.int16),
            list(zip(coders, indexes)))
        return planes[0] if len(planes) == 1 else np.concatenate(planes)

    def _encode_rows(self, planes: dict) -> list:
        """Host symbol planes (N rows) -> N rANS streams, one per row."""
        n = next(iter(planes.values())).shape[0]
        rows = [{k: v[i:i + 1] for k, v in planes.items()} for i in range(n)]
        with _pool(n) as pool:
            return _map(pool, self._encode_host, rows)

    # ----------------------------------------------------------------- fleet
    def set_fleet_sharding(self, devices) -> int:
        """Serve batched calls over `devices` (e.g. ["cuda:0", "cuda:1"];
        a device may repeat: its replicas then share it, each on its own
        stream). Returns the fleet's size."""
        if self._spatial is not None:
            raise ValueError("spatial and fleet sharding exclude each other:"
                             " this codec is split by rows")
        devices = [resolve_device(d) for d in devices]
        self._fleet = [type(self)(copy.deepcopy(self.model), device=d)
                       for d in devices]
        # one stream a replica for every call: the caching allocator keeps
        # its blocks per stream, so a new stream per call would hold more
        # device memory at each call
        self._fleet_streams = [torch.cuda.Stream(d) if d.type == "cuda"
                               else None for d in devices]
        return len(self._fleet)

    def set_spatial_sharding(self, mesh):
        """Split every call's frames by rows over `mesh`
        (parallel/spatial.make_spatial_mesh; every rank of it makes the
        same calls): the codec's model takes its spatial form in place.
        Within the mode the decoder reproduces the encoder's recon bit for
        bit; across modes, from equal DPB state, the streams are the
        unsharded engine's as long as the u8 scale indexes absorb the
        rounding of the other conv shapes, and the recons agree up to that
        rounding (the JAX engine's contract). Returns this rank's
        SpatialAxis."""
        if self._fleet:
            raise ValueError("spatial and fleet sharding exclude each other:"
                             " this codec serves a fleet")
        self._spatial = shard_spatial_model(self.model, mesh)
        return self._spatial

    def spatial_shard_tree(self, tree):
        """This rank's rows, on the codec's device, of each whole NHWC
        plane of `tree` (frames, the DPB) that tiles the spatial axis;
        other planes whole, other leaves as they are. No-op without
        spatial mode."""
        sp = self._spatial
        if sp is None:
            return tree

        def put(v):
            if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim == 4:
                return to_device(sp.own_rows(torch.as_tensor(v), 1),
                                 self.device)
            return v

        return map_tree(put, tree)

    def _fleet_call(self, n: int, method: str, *args):
        """getattr(replica, method)(*its rows of args) on every replica,
        joined in row order; None when no fleet is set or n rows do not
        tile it (the call then runs unsharded)."""
        fleet = self._fleet
        if not fleet or n % len(fleet):
            return None
        k = n // len(fleet)
        for replica in fleet:  # tables built by update() after the split
            for name in self._TABLES:
                setattr(replica, name, getattr(self, name))
        fns = [lambda r=r, i=i: getattr(r, method)(
            *(_take(a, slice(i * k, (i + 1) * k), n, r.device) for a in args))
            for i, r in enumerate(fleet)]
        return _gather(_on_streams(fns, self._fleet_streams), self.device)


class VideoCodec(_Engine):
    """DMC P-frames. Stream order per frame: mv_z, mv_y step 0, mv_y step 1,
    z, y step 0, y step 1 — six planes in one rANS stream."""

    _TABLES = ("y_table", "z_table", "z_mv_table")

    def __init__(self, model, device="cuda"):
        super().__init__(model, "laplace", device)
        self.z_mv_table = None

    def update(self, force: bool = False):
        if self.z_table is not None and not force:
            return
        self.y_table = self.gaussian.build_table()
        self.z_table = be.build_table(self.model.bit_estimator_z)
        self.z_mv_table = be.build_table(self.model.bit_estimator_z_mv)

    # ---------------------------------------------------------------- stages
    def _stage1(self, mv_z_hat, dpb):
        s, carry = self.model.decompress_stage1(self._sym_in(mv_z_hat), dpb)
        return self._idx_u8(s), carry

    def _stage2(self, mv_y_q_r_0, carry):
        s, carry = self.model.decompress_stage2(self._sym_in(mv_y_q_r_0),
                                                carry)
        return self._idx_u8(s), carry

    def _stage3a(self, mv_y_q_r_1, carry, dpb, mv_q, is_first_p):
        return self.model.decompress_stage3a(self._sym_in(mv_y_q_r_1), carry,
                                             dpb, mv_q, is_first_p)

    def _stage3b(self, z_hat, context3, dpb):
        s, carry = self.model.decompress_stage3b(self._sym_in(z_hat),
                                                 context3, dpb)
        return self._idx_u8(s), carry

    def _stage5(self, y_q_r_0, carry):
        s, carry = self.model.decompress_stage5(self._sym_in(y_q_r_0), carry)
        return self._idx_u8(s), carry

    def _stage6(self, y_q_r_1, carry, contexts, y_q):
        out = self.model.decompress_stage6(self._sym_in(y_q_r_1), carry,
                                           contexts, y_q)
        out["dpb"] = {k: v.to(self.param_dtype)
                      for k, v in out["dpb"].items()}
        return out

    # ---------------------------------------------------------------- forward
    @torch.no_grad()
    def forward(self, x, dpb, mv_y_q_scale, y_q_scale, is_first_p=False):
        out = self._fleet_call(len(x), "forward", x, dpb, mv_y_q_scale,
                               y_q_scale, is_first_p)
        if out is not None:
            return out
        with self._frame_of(x):
            return self.model(self._frame(x), dpb, mv_y_q_scale, y_q_scale,
                              is_first_p)

    # --------------------------------------------------------------- compress
    def _compress_planes(self, x, dpb, mv_y_q_scale, y_q_scale, is_first_p):
        """The encode chain: the decoder's stages interleaved with the
        encoder-only analysis and symbol quantization. All on the device:
        nothing here waits for it."""
        m = self.model
        x = self._frame(x)
        mv_y, mv_z_hat = m.encode_front(x, dpb, mv_y_q_scale)
        mv_z_hat = _i16(mv_z_hat)
        idx0, carry = self._stage1(mv_z_hat, dpb)
        mv_w0 = self._sym0(mv_y, carry[0], carry[2])
        idx1, carry = self._stage2(mv_w0, carry)
        mv_w1 = self._sym1(mv_y, carry[2], carry[3], carry[4])
        contexts = self._stage3a(mv_w1, carry, dpb, mv_y_q_scale, is_first_p)
        y, z_hat = m.encode_latent(x, contexts, y_q_scale)
        z_hat = _i16(z_hat)
        idx_y0, carry = self._stage3b(z_hat, contexts[2], dpb)
        y_w0 = self._sym0(y, carry[0], carry[2])
        idx_y1, carry = self._stage5(y_w0, carry)
        y_w1 = self._sym1(y, carry[2], carry[3], carry[4])
        out6 = self._stage6(y_w1, carry, contexts, y_q_scale)
        return {
            "mv_z_hat": mv_z_hat,
            "mv_y_q_w_0": mv_w0, "mv_idx_w_0": idx0,
            "mv_y_q_w_1": mv_w1, "mv_idx_w_1": idx1,
            "z_hat": z_hat,
            "y_q_w_0": y_w0, "idx_w_0": idx_y0,
            "y_q_w_1": y_w1, "idx_w_1": idx_y1,
            "dpb": out6["dpb"],
        }

    def _pull(self, out) -> _Pull:
        """Queue one frame's ten planes to the host (JAX: one device_get)."""
        return self._pull_planes({k: v for k, v in out.items() if k != "dpb"})

    def _encode_host(self, h) -> bytes:
        """One frame's host symbol planes -> its rANS stream (a fresh coder
        per call, so concurrent calls share no encoder state)."""
        coder = EntropyCoder()
        coder.reset_encoder()
        coder.encode_with_indexes(
            h["mv_z_hat"], be.build_indexes(h["mv_z_hat"].shape),
            self.z_mv_table)
        coder.encode_with_indexes(h["mv_y_q_w_0"], h["mv_idx_w_0"],
                                  self.y_table)
        coder.encode_with_indexes(h["mv_y_q_w_1"], h["mv_idx_w_1"],
                                  self.y_table)
        coder.encode_with_indexes(
            h["z_hat"], be.build_indexes(h["z_hat"].shape), self.z_table)
        coder.encode_with_indexes(h["y_q_w_0"], h["idx_w_0"], self.y_table)
        coder.encode_with_indexes(h["y_q_w_1"], h["idx_w_1"], self.y_table)
        return coder.flush_encoder()

    @torch.no_grad()
    def compress(self, x, dpb, mv_y_q_scale, y_q_scale, is_first_p=False):
        self._check_tables()
        with self._frame_of(x):
            out = self._compress_planes(x, dpb, mv_y_q_scale, y_q_scale,
                                        is_first_p)
            pull = self._pull(out)
        return {"bit_stream": self._encode_host(pull.wait()),
                "dpb": out["dpb"]}

    @torch.no_grad()
    def compress_batch(self, x, dpb, mv_y_q_scale, y_q_scale,
                       is_first_p=False):
        """Compress N independent streams (rate points or sequences) in one
        batched device pass: x and the DPB have a leading N, the q scales
        are floats or (N, 1, 1, 1) arrays. Each row becomes its own rANS
        stream, byte-identical to compress() of that row alone.

        Returns {"bit_streams": [bytes] * N, "dpb": batched dpb}."""
        self._check_tables()
        out = self._fleet_call(len(x), "compress_batch", x, dpb,
                               mv_y_q_scale, y_q_scale, is_first_p)
        if out is not None:
            return out
        with self._frame_of(x):
            out = self._compress_planes(x, dpb, mv_y_q_scale, y_q_scale,
                                        is_first_p)
            pull = self._pull(out)
        return {"bit_streams": self._encode_rows(pull.wait()),
                "dpb": out["dpb"]}

    @torch.no_grad()
    def encode_gop(self, frames, dpb, mv_y_q_scale, y_q_scale,
                   is_first_p=True):
        """Encode a burst of P-frames, each off the previous frame's
        decoder-exact DPB, one frame kept pending: frame t's pull is queued
        behind its chain, frame t+1's chain is dispatched, and only then
        does the host wait for frame t's planes and rANS-encode them, while
        the device runs frame t+1. Streams are byte-identical to
        sequential compress() calls. Returns (list of streams, final
        dpb)."""
        self._check_tables()
        streams, pending = [], None
        for i, x in enumerate(frames):
            with self._frame_of(x):
                out = self._compress_planes(x, dpb, mv_y_q_scale, y_q_scale,
                                            is_first_p and i == 0)
                pull = self._pull(out)
            dpb = out["dpb"]
            if pending is not None:
                streams.append(self._encode_host(pending.wait()))
            pending = pull
        if pending is not None:
            streams.append(self._encode_host(pending.wait()))
        return streams, dpb

    # ------------------------------------------------------------- decompress
    def _decode_frame(self, pool, coders, mv_z_hat, dpb, mv_y_q_scale,
                      y_q_scale, is_first_p, z_idx, during_stage1=None):
        """One frame of every stream in lockstep: the device stages
        interleaved with the host rANS reads. `mv_z_hat` is the leading
        plane, already host-decoded (its indexes are static);
        `during_stage1()` runs on the host while stage 1 computes. Returns
        the stage-6 output plus "symbols", the six decoded planes."""
        static = [z_idx] * len(coders)

        def read(indexes, table):
            return self._read(pool, coders, indexes, table)

        idx0, carry = self._stage1(self._up(mv_z_hat), dpb)
        pull = self._pull_planes({"idx": idx0})
        if during_stage1 is not None:
            during_stage1()
        mv_y_q_r_0 = read(_rows(pull.wait()["idx"]), self.y_table)
        idx1, carry = self._stage2(self._up(mv_y_q_r_0), carry)
        mv_y_q_r_1 = read(_rows(self._fetch(idx1)), self.y_table)
        contexts = self._stage3a(self._up(mv_y_q_r_1), carry, dpb,
                                 mv_y_q_scale, is_first_p)
        z_hat = read(static, self.z_table)  # while stage 3a runs
        idx_y0, carry = self._stage3b(self._up(z_hat), contexts[2], dpb)
        y_q_r_0 = read(_rows(self._fetch(idx_y0)), self.y_table)
        idx_y1, carry = self._stage5(self._up(y_q_r_0), carry)
        y_q_r_1 = read(_rows(self._fetch(idx_y1)), self.y_table)
        out = self._stage6(self._up(y_q_r_1), carry, contexts, y_q_scale)
        out["symbols"] = (mv_z_hat, mv_y_q_r_0, mv_y_q_r_1, z_hat, y_q_r_0,
                          y_q_r_1)
        return out

    def _z_idx(self, height, width):
        zh, zw = bs.get_downsampled_shape(height, width, 64)
        return be.build_indexes((1, zh, zw, self.model.channel_N))

    @torch.no_grad()
    def decompress(self, dpb, stream: bytes, height: int, width: int,
                   mv_y_q_scale, y_q_scale, is_first_p=False,
                   return_symbols=False):
        """Decode one frame's stream. With `return_symbols`, out["symbols"]
        holds the six decoded planes (mv_z, mv_y0, mv_y1, z, y0, y1)."""
        return self.decompress_batch(dpb, [stream], height, width,
                                     mv_y_q_scale, y_q_scale, is_first_p,
                                     return_symbols)

    @torch.no_grad()
    def decompress_batch(self, dpb, streams, height: int, width: int,
                         mv_y_q_scale, y_q_scale, is_first_p=False,
                         return_symbols=False):
        """Decode N independent streams in lockstep through the batch axis
        of each stage (one DPB row and one q row per stream), identical to
        N decompress() calls; each stream has its own coder, and the N rANS
        reads of a plane run on a thread pool."""
        self._check_tables()
        out = self._fleet_call(len(streams), "decompress_batch", dpb,
                               list(streams), height, width, mv_y_q_scale,
                               y_q_scale, is_first_p, return_symbols)
        if out is not None:
            return out
        coders = _decoders(streams)
        z_idx = self._z_idx(height, width)
        with _pool(len(coders)) as pool, self._sized(height, width):
            mv_z_hat = self._read(pool, coders, [z_idx] * len(coders),
                                  self.z_mv_table)
            out = self._decode_frame(pool, coders, mv_z_hat, dpb,
                                     mv_y_q_scale, y_q_scale, is_first_p,
                                     z_idx)
        if not return_symbols:
            del out["symbols"]
        return out

    @torch.no_grad()
    def decode_gop(self, dpb, streams, height: int, width: int,
                   mv_y_q_scale, y_q_scale, is_first_p=True):
        """Decode a burst of per-frame streams. While frame t's stage 1
        runs, the host decodes frame t+1's mv_z plane; the DPB stays on the
        device and only each frame's recon is kept. Identical to
        sequential decompress() calls. Returns (list of decoded frames
        (1, H, W, 3) on the device, final dpb)."""
        self._check_tables()
        z_idx = self._z_idx(height, width)
        coders = _decoders(streams)
        mv_z = {}

        def prefetch(i):
            if i < len(coders):
                mv_z[i] = self._read(None, coders[i:i + 1], [z_idx],
                                     self.z_mv_table)

        prefetch(0)
        outs = []
        with self._sized(height, width):
            for i in range(len(coders)):
                dpb = self._decode_frame(
                    None, coders[i:i + 1], mv_z.pop(i), dpb, mv_y_q_scale,
                    y_q_scale, is_first_p and i == 0, z_idx,
                    during_stage1=lambda i=i: prefetch(i + 1))["dpb"]
                outs.append(dpb["ref_frame"])
        return outs, dpb

    # ----------------------------------------------------------- encode+decode
    def encode_decode(self, x, dpb, output_path=None, pic_width=None,
                      pic_height=None, mv_y_q_scale=None, y_q_scale=None,
                      is_first_p=False):
        """Write-then-read round trip through the .bin container (the
        decoded DPB, and the encoder's recon as "encoded_ref_frame");
        without an output path, the entropy-estimated forward."""
        if output_path is None:
            out = self.forward(x, dpb, mv_y_q_scale, y_q_scale, is_first_p)
            res = {k: float(out[k]) for k in
                   ("bit_y", "bit_z", "bit_mv_y", "bit_mv_z", "bit")}
            return {"dpb": out["dpb"], **res, "decoding_time": 0.0}
        mv_y_q_scale, mv_y_q_index = bs.get_rounded_q(mv_y_q_scale)
        y_q_scale, y_q_index = bs.get_rounded_q(y_q_scale)
        t0 = time.time()
        encoded = self.compress(x, dpb, mv_y_q_scale, y_q_scale, is_first_p)
        bs.encode_p(encoded["bit_stream"], mv_y_q_index, y_q_index,
                    output_path)
        bit = bs.filesize(output_path) * 8
        t1 = time.time()
        mv_y_q_index, y_q_index, stream = bs.decode_p(output_path)
        decoded = self.decompress(dpb, stream, pic_height, pic_width,
                                  mv_y_q_index / 100, y_q_index / 100,
                                  is_first_p)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t2 = time.time()
        return {"dpb": decoded["dpb"], "bit": bit,
                "encoded_ref_frame": encoded["dpb"]["ref_frame"],
                "encoding_time": t1 - t0, "decoding_time": t2 - t1}


class IntraCodec(_Engine):
    """IntraNoAR I-frames: z, y step 0, y step 1 in one rANS stream."""

    def __init__(self, model, device="cuda"):
        super().__init__(model, "gaussian", device)

    def update(self, force: bool = False):
        """Build the quantized CDF tables."""
        if self.z_table is not None and not force:
            return
        self.y_table = self.gaussian.build_table()
        self.z_table = be.build_table(self.model.bit_estimator_z)

    @torch.no_grad()
    def forward(self, x, q_scale):
        """Entropy-estimated path (no real bitstream)."""
        out = self._fleet_call(len(x), "forward", x, q_scale)
        if out is not None:
            return out
        with self._frame_of(x):
            return self.model(self._frame(x), q_scale)

    def _stage1(self, z_hat, q_scale):
        s, carry = self.model.decompress_stage1(self._sym_in(z_hat), q_scale)
        return self._idx_u8(s), carry

    def _stage2(self, y_q_r_0, carry):
        s, carry = self.model.decompress_stage2(self._sym_in(y_q_r_0), carry)
        return self._idx_u8(s), carry

    def _stage3(self, y_q_r_1, carry, q_scale):
        return self.model.decompress_stage3(self._sym_in(y_q_r_1), carry,
                                            q_scale)

    def _compress_planes(self, x, q_scale):
        y, z_hat = self.model.encode_front(self._frame(x), q_scale)
        z_hat = _i16(z_hat)
        idx0, carry = self._stage1(z_hat, q_scale)
        y_w0 = self._sym0(y, carry[0], carry[2])
        idx1, carry = self._stage2(y_w0, carry)
        y_w1 = self._sym1(y, carry[2], carry[3], carry[4])
        return {"z_hat": z_hat, "y_q_w_0": y_w0, "idx_w_0": idx0,
                "y_q_w_1": y_w1, "idx_w_1": idx1}

    def _encode_host(self, h) -> bytes:
        coder = EntropyCoder()
        coder.reset_encoder()
        coder.encode_with_indexes(h["z_hat"], be.build_indexes(
            h["z_hat"].shape), self.z_table)
        coder.encode_with_indexes(h["y_q_w_0"], h["idx_w_0"], self.y_table)
        coder.encode_with_indexes(h["y_q_w_1"], h["idx_w_1"], self.y_table)
        return coder.flush_encoder()

    @torch.no_grad()
    def compress(self, x, q_scale) -> bytes:
        self._check_tables()
        with self._frame_of(x):
            pull = self._pull_planes(self._compress_planes(x, q_scale))
        return self._encode_host(pull.wait())

    @torch.no_grad()
    def compress_batch(self, x, q_scale) -> list:
        """N rows in one batched device pass (q: a float or (N, 1, 1, 1));
        one rANS stream per row, byte-identical to compress() of each row
        alone."""
        self._check_tables()
        out = self._fleet_call(len(x), "compress_batch", x, q_scale)
        if out is not None:
            return out
        with self._frame_of(x):
            pull = self._pull_planes(self._compress_planes(x, q_scale))
        return self._encode_rows(pull.wait())

    @torch.no_grad()
    def decompress(self, stream: bytes, height: int, width: int, q_scale):
        """Returns the decoded frame (1, H, W, 3), NHWC, on the device."""
        return self.decompress_batch([stream], height, width, q_scale)

    @torch.no_grad()
    def decompress_batch(self, streams, height: int, width: int, q_scale):
        """Decode N streams in lockstep through batched stages; returns the
        decoded frames (N, H, W, 3), identical to N decompress() calls."""
        self._check_tables()
        out = self._fleet_call(len(streams), "decompress_batch",
                               list(streams), height, width, q_scale)
        if out is not None:
            return out
        coders = _decoders(streams)
        zh, zw = bs.get_downsampled_shape(height, width, 64)
        z_idx = be.build_indexes((1, zh, zw, self.model.N))

        with _pool(len(coders)) as pool, self._sized(height, width):
            z_hat = self._read(pool, coders, [z_idx] * len(coders),
                               self.z_table)
            idx0, carry = self._stage1(self._up(z_hat), q_scale)
            y_q_r_0 = self._read(pool, coders, _rows(self._fetch(idx0)),
                                 self.y_table)
            idx1, carry = self._stage2(self._up(y_q_r_0), carry)
            y_q_r_1 = self._read(pool, coders, _rows(self._fetch(idx1)),
                                 self.y_table)
            return self._stage3(self._up(y_q_r_1), carry, q_scale)

    def encode_decode(self, x, q_scale, output_path=None, pic_width=None,
                      pic_height=None):
        """Write-then-read round trip through the .bin container."""
        if output_path is None:
            out = self.forward(x, q_scale)
            return {"bit": float(out["bit"]), "x_hat": out["x_hat"],
                    "encoding_time": 0.0, "decoding_time": 0.0}
        if pic_height is None or pic_width is None:
            raise ValueError("pic_height and pic_width are required")
        q_scale, q_index = bs.get_rounded_q(q_scale)
        t0 = time.time()
        stream = self.compress(x, q_scale)
        bs.encode_i(pic_height, pic_width, q_index, stream, output_path)
        bit = bs.filesize(output_path) * 8
        t1 = time.time()
        height, width, q_index, stream = bs.decode_i(output_path)
        x_hat = self.decompress(stream, height, width, q_index / 100)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t2 = time.time()
        return {"bit": bit, "x_hat": x_hat, "encoding_time": t1 - t0,
                "decoding_time": t2 - t1}
