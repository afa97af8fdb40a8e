"""Device selection and the numerics every entry point runs under."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. "cuda" is the default and must
    exist: there is no silent fall back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run on the CPU")
    return dev


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A tensor onto `device` without a host wait: a CPU tensor bound for
    the card goes through pinned memory and is queued on the current
    stream behind the work already there (a blocking copy would wait for
    that work)."""
    device = torch.device(device)
    if device.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def set_codec_numerics() -> None:
    """f32 without TF32, and cuDNN algorithms fixed per shape.

    The encoder and the decoder run the same stage functions; the stream
    stays decodable only if both get bit-identical results from them, so a
    conv may not pick its algorithm by timing (benchmark) or by run-to-run
    non-deterministic reductions. TF32 would also break f32 parity."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
