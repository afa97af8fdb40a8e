"""CTC loss with optax.ctc_loss's semantics, for the plate OCR trainer.

`ctc_loss(logits, labels, label_paddings)`: (B, T, K) logits, (B, N)
integer labels right-padded and the (B, N) paddings as optax takes them
(1.0 where padded), blank = 0, no logit padding (the trainer pads none).
Returns each sequence's negative log-likelihood, (B,), not divided by its
length (F.ctc_loss's "mean" would divide).

- On the CPU: `ctc_loss_plain`, optax's log-space alpha recursion
  (optax/losses/_classification.py ctc_loss_with_forward_probs) written
  out in torch ops, log(0) approximated by -1e5 as optax does; its
  gradient comes from autograd through the recursion.
- On the card: `ctc_loss_fb`, the alpha and beta recursions over the
  blank-interleaved labels and the gradient in closed form (softmax minus
  the posterior occupancy of each class). Every op sums in a fixed order
  (the gathers and the occupancy's sum over label positions are products
  with one-hot matrices), so a step repeats bit for bit. PyTorch's own
  CUDA CTC backward adds with atomics and does not repeat; cuDNN's CTC
  (through F.ctc_loss) gave d logits that differed from this recursion's
  by more than the gradients' own size on the H100 (PERF.md, PR 15). The
  route takes log(0) as -inf where optax takes -1e5: on inputs with a
  path (T >= the label length plus its repeats; the route raises
  otherwise) the two agree to rounding.

`chip_smoke.py` holds the card route against the plain version on the
card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

LOG_EPSILON = -1e5


def _host_labels(labels, label_paddings):
    """(labels int64 (B, N), lengths int64 (B,)) of host arrays."""
    lab = np.asarray(labels, np.int64)
    return lab, lab.shape[1] - np.asarray(label_paddings).sum(
        axis=1).astype(np.int64)


def ctc_loss_plain(logits: torch.Tensor, labels, label_paddings
                   ) -> torch.Tensor:
    """optax.ctc_loss(logits, zeros, labels, label_paddings) in torch."""
    b, t_len, k = logits.shape
    lab, lens = _host_labels(labels, label_paddings)
    n = lab.shape[1]
    dev, dt = logits.device, logits.dtype
    logprobs = torch.log_softmax(logits, dim=-1)
    rep = np.zeros((b, n), np.float32)
    rep[:, :-1] = lab[:, :-1] == lab[:, 1:]
    repeat = torch.from_numpy(rep).to(dev, dt)
    one_hot = F.one_hot(torch.from_numpy(lab).to(dev), k).to(dt)
    # (T, B, N) emit and (T, B, 1) blank log-probabilities
    emit = torch.einsum("btk,bnk->tbn", logprobs, one_hot)
    phi_lp = logprobs[:, :, :1].transpose(0, 1)
    phi = torch.full((b, n + 1), LOG_EPSILON, dtype=dt, device=dev)
    phi = torch.cat([torch.zeros_like(phi[:, :1]), phi[:, 1:]], 1)
    em = torch.full((b, n), LOG_EPSILON, dtype=dt, device=dev)

    def add_phi(p, added):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], added)], 1)

    for t in range(t_len):
        prev_phi = add_phi(phi, em + LOG_EPSILON * repeat)
        next_em = torch.logaddexp(prev_phi[:, :-1] + emit[t], em + emit[t])
        next_phi = add_phi(prev_phi + phi_lp[t],
                           em + phi_lp[t] + LOG_EPSILON * (1.0 - repeat))
        phi, em = next_phi, next_em
    last = add_phi(phi, em)
    pick = F.one_hot(torch.from_numpy(lens).to(dev), n + 1).to(dt)
    return -(last * pick).sum(1)


def _extended(lab: np.ndarray, lens: np.ndarray):
    """The blank-interleaved label sequences (B, S = 2N + 1), their
    lengths 2 len + 1, and where a path may skip from s - 2 to s (a
    label that differs from the one before it)."""
    b, n = lab.shape
    ext = np.zeros((b, 2 * n + 1), np.int64)
    ext[:, 1::2] = lab
    skip = np.zeros(ext.shape, bool)
    skip[:, 2:] = (ext[:, 2:] != 0) & (ext[:, 2:] != ext[:, :-2])
    return ext, 2 * lens + 1, skip


class _CTCForwardBackward(torch.autograd.Function):
    """-log p(labels | logits) by the alpha and beta recursions over the
    blank-interleaved labels, its gradient in closed form:
    softmax - (the posterior occupancy of each class), as Graves et al.
    derive it. Gathers and the occupancy's sum over label positions are
    products with one-hot matrices, so no op adds with atomics. Computed in
    float64 (a few thousand elements a step): in f32 the occupancy's
    exponent alpha + beta - lp - ll cancels terms near -100 and d logits
    lands up to 7e-5 (of the largest) from the exact value."""

    @staticmethod
    def forward(ctx, logits, ext_t, ext_len, skip_t):
        ctx.dtype = logits.dtype
        neg = torch.tensor(float("-inf"), dtype=torch.float64,
                           device=logits.device)
        logp = torch.log_softmax(logits.double(), dim=-1)
        b, t_len, k = logp.shape
        one_hot = F.one_hot(ext_t, k).to(logp.dtype)
        lp = torch.einsum("btk,bsk->tbs", logp, one_hot)  # (T, B, S)
        s_len = ext_t.shape[1]
        pos = torch.arange(s_len, device=logits.device)
        valid = pos[None] < ext_len[:, None]

        def shift(x, n):
            return torch.cat([neg.expand(b, n), x[:, :-n]], 1)

        def shift_back(x, n):
            return torch.cat([x[:, n:], neg.expand(b, n)], 1)

        alpha = [torch.where(pos[None] < 2, lp[0], neg)]
        for t in range(1, t_len):
            a = alpha[-1]
            a = torch.logaddexp(a, shift(a, 1))
            a = torch.where(skip_t, torch.logaddexp(a, shift(alpha[-1], 2)),
                            a)
            alpha.append(torch.where(valid, a + lp[t], neg))
        last = ext_len[:, None] - 1
        ends = (pos[None] == last) | (pos[None] == last - 1)
        beta = [torch.where(ends & valid, lp[-1], neg)]
        # a path may skip from s to s + 2 where s + 2 may be skipped to
        skip_next = torch.cat([skip_t[:, 2:], torch.zeros_like(
            skip_t[:, :2])], 1)
        for t in range(t_len - 2, -1, -1):
            c = beta[-1]
            c2 = torch.logaddexp(c, shift_back(c, 1))
            c2 = torch.where(skip_next, torch.logaddexp(
                c2, shift_back(c, 2)), c2)
            beta.append(torch.where(valid, c2 + lp[t], neg))
        alpha = torch.stack(alpha)
        beta = torch.stack(beta[::-1])
        ll = torch.logsumexp(torch.where(ends, alpha[-1], neg), dim=1)
        ctx.save_for_backward(logp, one_hot, alpha, beta, lp, ll)
        return (-ll).to(ctx.dtype)

    @staticmethod
    def backward(ctx, grad_out):
        logp, one_hot, alpha, beta, lp, ll = ctx.saved_tensors
        occupancy = torch.exp(alpha + beta - lp - ll[None, :, None])
        post = torch.einsum("tbs,bsk->btk", occupancy, one_hot)
        grad = (torch.exp(logp) - post) * grad_out.double()[:, None, None]
        return grad.to(ctx.dtype), None, None, None


def ctc_loss_fb(logits: torch.Tensor, labels, label_paddings
                ) -> torch.Tensor:
    """The card route: the forward-backward recursions with the closed
    form gradient (_CTCForwardBackward)."""
    lab, lens = _host_labels(labels, label_paddings)
    ext, ext_len, skip = _extended(lab, lens)
    # a path needs a step per label and a blank between repeated labels
    repeats = ((ext[:, 2:] == ext[:, :-2]) & (ext[:, 2:] != 0)
               & (np.arange(2, ext.shape[1]) < ext_len[:, None])).sum(1)
    if (lens + repeats > logits.shape[1]).any():
        raise ValueError("a label sequence needs more steps than the "
                         "logits have")
    dev = logits.device
    return _CTCForwardBackward.apply(
        logits, torch.from_numpy(ext).to(dev),
        torch.from_numpy(ext_len).to(dev), torch.from_numpy(skip).to(dev))


def ctc_loss(logits: torch.Tensor, labels, label_paddings) -> torch.Tensor:
    """Per-sequence CTC negative log-likelihood (optax.ctc_loss): the
    plain version for a CPU tensor, the forward-backward route for a CUDA
    one."""
    if logits.device.type == "cpu":
        return ctc_loss_plain(logits, labels, label_paddings)
    return ctc_loss_fb(logits, labels, label_paddings)
