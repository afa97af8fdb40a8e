"""PyTorch port, kernel D: the plain two-pass warp against the JAX Pallas
kernel (interpret mode, as tests/test_warp_pallas.py runs it), and
DMC(fast_warp=True) against the JAX DMC(fast_warp=True) on the CPU.

Tolerances: f32 atol 1e-6 on values in [0, 1] (XLA contracts a lerp into
an FMA where the port rounds every op: 1-2 f32 ulps); bf16 within one bf16
ulp of |out| (both stacks lerp in f32 and round once, so only f32 values
that straddle a bf16 rounding boundary can differ). The model: DPB atol
1e-4 and bpp/mse/me_mse rtol 1e-4, as tests/test_torch_models.py holds the
exact-warp model, on the port's seeded damped init carried into the JAX
model. The kernel itself is compared with this plain version on
the card (tests/test_torch_kernels_cuda.py and chip_smoke.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vcm_ts_tpu.ops.warp_pallas as j_warp_pallas
from tests.torch_port_util import moving_frames, nchw, nhwc, np_tree
from vcm_ts_tpu.models.dmc import DMC as JDMC
from vcm_ts_tpu.models.dmc import make_dpb as j_make_dpb
from vcm_ts_tpu.utils.weight_import import import_state_dict
from vcm_ts_tpu_torch.models import dmc as t_dmc
from vcm_ts_tpu_torch.models import video_net as t_video_net
from vcm_ts_tpu_torch.models.dmc import make_dpb
from vcm_ts_tpu_torch.ops.warp_twopass import flow_warp_twopass
from vcm_ts_tpu_torch.utils.weights import make_dmc

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch CPU thread while a module's tests run (import this fixture
    into a module to use it there): under pytest-xdist every worker would
    otherwise start one thread per core, and the workers' torch ops then
    slow each other down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flax_params_like(init_fn, module: torch.nn.Module) -> dict:
    """JAX params holding a port module's weights: the flax tree's shapes
    come from tracing `init_fn` (no compile, no eager init, which takes
    over a minute for the DMC on a CPU), its values from the module's
    state dict through the JAX package's import_state_dict."""
    shapes = jax.eval_shape(init_fn)
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = {k: v.detach().float().cpu().numpy()
          for k, v in module.state_dict().items()}
    return import_state_dict(template, sd)


P_SCALARS = ("bpp", "bpp_y", "bpp_z", "mse", "bpp_mv_y", "bpp_mv_z",
             "me_mse")


def _bf16_ulp(v):
    """One bf16 ulp at |v| (8 significand bits)."""
    mag = np.maximum(np.abs(v), np.float32(2.0 ** -126))
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


# n, h, w, c, max_disp, dtype
@pytest.mark.parametrize("n,h,w,c,d,dtype", [
    (1, 16, 128, 16, 8, "f32"),   # W a multiple of 128: the lane roll wraps
    (2, 21, 100, 3, 4, "f32"),    # N=2, H not a multiple of 8, C=3, W padded
    (2, 13, 128, 20, 6, "bf16"),  # C not a multiple of 16
    (1, 24, 72, 64, 24, "bf16"),  # the DMC's full-resolution bound
])
def test_plain_twopass_matches_pallas_interpret(n, h, w, c, d, dtype):
    rng = np.random.default_rng(h * w + c)
    im = rng.random((n, h, w, c)).astype(np.float32)
    # |flow| well past D: the shift clamp and the image clamp both act
    flow = rng.normal(0, 2.0 * d, (n, h, w, 2)).astype(np.float32)
    assert (np.abs(flow) > d + 1).mean() > 0.2
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = np.asarray(j_warp_pallas.flow_warp_pallas(
        jnp.asarray(im, jdt), jnp.asarray(flow), max_disp=d,
        interpret=True).astype(jnp.float32))
    got = flow_warp_twopass(nchw(im).to(tdt), nchw(flow), d)
    assert got.dtype == tdt and got.shape == (n, c, h, w)
    got = nhwc(got.float())
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()


def test_plain_twopass_exact_for_flows_constant_along_x():
    """The separable approximation is exact where the flow does not vary
    along x: then it equals the exact warp up to the lerp form."""
    from vcm_ts_tpu_torch.ops.warp import flow_warp

    rng = np.random.default_rng(5)
    im = rng.random((1, 12, 40, 8)).astype(np.float32)
    flow = np.zeros((1, 12, 40, 2), np.float32)
    flow[..., 0] = 2.75
    flow[..., 1] = rng.normal(0, 1.5, (1, 12, 1))
    np.testing.assert_allclose(
        nhwc(flow_warp_twopass(nchw(im), nchw(flow), 8)),
        nhwc(flow_warp(nchw(im), nchw(flow))), rtol=0, atol=1e-6)


def test_twopass_refuses_devices_without_a_version():
    x = torch.empty((1, 4, 2, 2), device="meta")
    with pytest.raises(ValueError):
        flow_warp_twopass(x, torch.empty((1, 2, 2, 2), device="meta"), 4)


@pytest.fixture(scope="module")
def fast_dmc():
    """The port's seeded damped DMC and the JAX DMC holding its weights."""
    jmodel = JDMC(anchor_num=4, fast_warp=True)
    port = make_dmc("cpu", fast_warp=True).eval()
    x0 = jnp.zeros((1, 64, 64, 3))
    params = flax_params_like(
        lambda: jmodel.init(jax.random.PRNGKey(0), x0, j_make_dpb(x0), 1.0,
                            1.0, method="init_all"), port)
    return jmodel, params, port


def test_dmc_fast_warp_matches_jax(fast_dmc, monkeypatch):
    """Two chained P-frames (is_first_p on the first) through the JAX
    DMC(fast_warp=True), its Pallas warp in interpret mode, and the port's
    DMC(fast_warp=True); the port runs no exact warp on that path."""
    monkeypatch.setattr(j_warp_pallas, "flow_warp_pallas",
                        partial(j_warp_pallas.flow_warp_pallas,
                                interpret=True))

    def exact_warp(*args):
        raise AssertionError("the fast_warp path called the exact warp")

    for mod, name in ((t_dmc, "flow_warp"), (t_dmc, "flow_warp_packed"),
                      (t_video_net, "flow_warp")):
        monkeypatch.setattr(mod, name, exact_warp)
    jmodel, params, port = fast_dmc
    frames = moving_frames(4, 3)
    fwd = jax.jit(partial(jmodel.apply, params),
                  static_argnames=("is_first_p",))
    jdpb = j_make_dpb(jnp.asarray(frames[0]))
    tdpb = make_dpb(torch.from_numpy(frames[0]))
    for t, x in enumerate(frames[1:]):
        first = t == 0
        want = fwd(jnp.asarray(x), jdpb, 0.7, 0.8, is_first_p=first)
        with torch.no_grad():
            got = port(torch.from_numpy(x), tdpb, 0.7, 0.8, is_first_p=first)
        for k in ("ref_frame", "ref_feature", "ref_y", "ref_mv_y"):
            np.testing.assert_allclose(
                np_tree(got["dpb"][k]), np.asarray(want["dpb"][k]), rtol=0,
                atol=1e-4, err_msg=f"frame {t}: dpb {k}")
        for k in P_SCALARS:
            np.testing.assert_allclose(np_tree(got[k]), np.asarray(want[k]),
                                       rtol=1e-4, atol=0,
                                       err_msg=f"frame {t}: {k}")
        jdpb, tdpb = want["dpb"], got["dpb"]
