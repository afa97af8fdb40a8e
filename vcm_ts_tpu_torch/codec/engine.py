"""Codec engines: run the models' stages around the host rANS coder.

Counterpart of the single-stream part of vcm_ts_tpu/codec/engine.py
(`IntraCodec`, `VideoCodec`): `update`, `forward`, `compress`,
`decompress`, `encode_gop`, `decode_gop`, `encode_decode`. Between stages
only int16 symbol planes and uint8 scale-index planes cross to the host.

The ENCODER derives every prior the stream depends on through the decoder's
own stage methods (plus encoder-only analysis), so encoder and decoder see
bit-identical priors on any frame chain. On the GPU that also needs cuDNN
to pick the same algorithm for the same conv every time:
`set_codec_numerics` fixes that (deterministic, no benchmark, no TF32), and
every symbol plane enters a stage in one canonical form (parameter dtype,
dense NHWC), whether it came from the encoder or from the stream.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..entropy import bit_estimator as be
from ..entropy.coder import EntropyCoder
from ..entropy.gaussian import GaussianCoder
from ..models import common as cm
from ..utils.device import resolve_device, set_codec_numerics
from . import bitstream as bs


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


def _host(planes: dict) -> dict:
    """Device planes -> numpy, one copy each."""
    return {k: v.cpu().numpy() for k, v in planes.items()}


class _Engine:
    """What both codecs share: device placement, numerics, symbol IO."""

    def __init__(self, model, distribution: str, device):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_codec_numerics()
        self.model = model.to(self.device).eval()
        self.param_dtype = param_dtype(model)
        self.gaussian = GaussianCoder(distribution)
        self.y_table = None
        self.z_table = None

    def _sym_in(self, sym: torch.Tensor) -> torch.Tensor:
        """A symbol plane as a stage input: parameter dtype, dense NHWC."""
        return sym.to(self.param_dtype).contiguous()

    def _idx_u8(self, scales: torch.Tensor) -> torch.Tensor:
        return self.gaussian.build_indexes(scales).to(torch.uint8)

    def _up(self, symbols) -> torch.Tensor:
        return torch.from_numpy(
            np.ascontiguousarray(symbols, dtype=np.int16)).to(self.device)

    def _frame(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, device=self.device)
        return x.to(self.param_dtype).contiguous()

    def _sym0(self, y, means, q_step):
        return _i16(cm.encode_symbols_step0(y, means, q_step))

    def _sym1(self, y, means_0, means_1, q_step):
        return _i16(cm.encode_symbols_step1(y, means_0, means_1, q_step))


class VideoCodec(_Engine):
    """DMC P-frames. Stream order per frame: mv_z, mv_y step 0, mv_y step 1,
    z, y step 0, y step 1 — six planes in one rANS stream."""

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
        return self.model(self._frame(x), dpb, mv_y_q_scale, y_q_scale,
                          is_first_p)

    # --------------------------------------------------------------- compress
    def _compress_planes(self, x, dpb, mv_y_q_scale, y_q_scale, is_first_p):
        """The encode chain: the decoder's stages interleaved with the
        encoder-only analysis and symbol quantization."""
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

    def _host_encode(self, out) -> bytes:
        """One frame's symbol planes -> its rANS stream (fresh coder)."""
        h = _host({k: v for k, v in out.items() if k != "dpb"})
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
        if self.z_table is None:
            raise RuntimeError("call update() first")
        out = self._compress_planes(x, dpb, mv_y_q_scale, y_q_scale,
                                    is_first_p)
        return {"bit_stream": self._host_encode(out), "dpb": out["dpb"]}

    @torch.no_grad()
    def encode_gop(self, frames, dpb, mv_y_q_scale, y_q_scale,
                   is_first_p=True):
        """Encode a burst of P-frames, each off the previous frame's
        decoder-exact DPB. Returns (list of streams, final dpb)."""
        if self.z_table is None:
            raise RuntimeError("call update() first")
        streams = []
        for i, x in enumerate(frames):
            out = self._compress_planes(x, dpb, mv_y_q_scale, y_q_scale,
                                        is_first_p and i == 0)
            dpb = out["dpb"]
            streams.append(self._host_encode(out))
        return streams, dpb

    # ------------------------------------------------------------- decompress
    def _decode_one(self, coder, z_idx, dpb, mv_y_q_scale, y_q_scale,
                    is_first_p):
        mv_z_hat = coder.decode_stream(z_idx, self.z_mv_table)
        idx0, carry = self._stage1(self._up(mv_z_hat), dpb)
        mv_y_q_r_0 = coder.decode_stream(idx0.cpu().numpy(), self.y_table)
        idx1, carry = self._stage2(self._up(mv_y_q_r_0), carry)
        mv_y_q_r_1 = coder.decode_stream(idx1.cpu().numpy(), self.y_table)
        z_hat = coder.decode_stream(z_idx, self.z_table)
        contexts = self._stage3a(self._up(mv_y_q_r_1), carry, dpb,
                                 mv_y_q_scale, is_first_p)
        idx_y0, carry = self._stage3b(self._up(z_hat), contexts[2], dpb)
        y_q_r_0 = coder.decode_stream(idx_y0.cpu().numpy(), self.y_table)
        idx_y1, carry = self._stage5(self._up(y_q_r_0), carry)
        y_q_r_1 = coder.decode_stream(idx_y1.cpu().numpy(), self.y_table)
        return self._stage6(self._up(y_q_r_1), carry, contexts, y_q_scale)

    def _z_idx(self, height, width):
        zh, zw = bs.get_downsampled_shape(height, width, 64)
        return be.build_indexes((1, zh, zw, self.model.channel_N))

    @torch.no_grad()
    def decompress(self, dpb, stream: bytes, height: int, width: int,
                   mv_y_q_scale, y_q_scale, is_first_p=False):
        if self.z_table is None:
            raise RuntimeError("call update() first")
        coder = EntropyCoder()
        coder.set_stream(stream)
        return self._decode_one(coder, self._z_idx(height, width), dpb,
                                mv_y_q_scale, y_q_scale, is_first_p)

    @torch.no_grad()
    def decode_gop(self, dpb, streams, height: int, width: int,
                   mv_y_q_scale, y_q_scale, is_first_p=True):
        """Decode a burst of per-frame streams. Returns (list of decoded
        frames (1, H, W, 3), final dpb); only the recon is kept per frame."""
        if self.z_table is None:
            raise RuntimeError("call update() first")
        z_idx = self._z_idx(height, width)
        outs = []
        for i, stream in enumerate(streams):
            coder = EntropyCoder()
            coder.set_stream(stream)
            dpb = self._decode_one(coder, z_idx, dpb, mv_y_q_scale,
                                   y_q_scale, is_first_p and i == 0)["dpb"]
            outs.append(dpb["ref_frame"])
        return outs, dpb

    # ----------------------------------------------------------- encode+decode
    def encode_decode(self, x, dpb, output_path=None, pic_width=None,
                      pic_height=None, mv_y_q_scale=None, y_q_scale=None,
                      is_first_p=False):
        """Write-then-read round trip through the .bin container; without
        an output path, the entropy-estimated forward."""
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

    @torch.no_grad()
    def compress(self, x, q_scale) -> bytes:
        if self.z_table is None:
            raise RuntimeError("call update() first")
        h = _host(self._compress_planes(x, q_scale))
        coder = EntropyCoder()
        coder.reset_encoder()
        coder.encode_with_indexes(h["z_hat"], be.build_indexes(
            h["z_hat"].shape), self.z_table)
        coder.encode_with_indexes(h["y_q_w_0"], h["idx_w_0"], self.y_table)
        coder.encode_with_indexes(h["y_q_w_1"], h["idx_w_1"], self.y_table)
        return coder.flush_encoder()

    @torch.no_grad()
    def decompress(self, stream: bytes, height: int, width: int, q_scale):
        """Returns the decoded frame (1, H, W, 3), NHWC, on the device."""
        if self.z_table is None:
            raise RuntimeError("call update() first")
        zh, zw = bs.get_downsampled_shape(height, width, 64)
        z_idx = be.build_indexes((1, zh, zw, self.model.N))
        coder = EntropyCoder()
        coder.set_stream(stream)
        z_hat = coder.decode_stream(z_idx, self.z_table)
        idx0, carry = self._stage1(self._up(z_hat), q_scale)
        y_q_r_0 = coder.decode_stream(idx0.cpu().numpy(), self.y_table)
        idx1, carry = self._stage2(self._up(y_q_r_0), carry)
        y_q_r_1 = coder.decode_stream(idx1.cpu().numpy(), self.y_table)
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
