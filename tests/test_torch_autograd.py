"""The port's kernel autograd against the JAX package on the CPU: the
gradients of ``field_mlp.FusedResnetFC`` / ``FusedResnetFCPE`` (kernel
forward, plain-module backward; on the CPU the forward runs the kernels'
plain twins) against ``jax.grad`` through the JAX package's custom_vjps
``fused_resnetfc`` / ``fused_resnetfc_pe`` (Pallas in interpret mode) and
through its plain flax ``ResnetFC.apply``, with the same weights, inputs
and output cotangent."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pixelnerf_yolo_tpu.nn.code import PositionalEncoding as JPE
from pixelnerf_yolo_tpu.nn.resnetfc import ResnetFC as JResnetFC
from pixelnerf_yolo_tpu.ops.pallas import fused_mlp as jfm
from pixelnerf_yolo_torch.convert import resnetfc_state_dict
from pixelnerf_yolo_torch.nn.code import PositionalEncoding
from pixelnerf_yolo_torch.nn.resnetfc import ResnetFC
from pixelnerf_yolo_torch.ops import field_mlp

D_LAT, H, NB, CL, D_OUT = 64, 64, 5, 3, 21
FREQS = tuple(1.5 * 2.0**i for i in range(6))
D_PE = 42  # PE of xyz (39) with viewdirs appended
D_ZF = 78  # z-features of a model that encodes viewdirs too
SB, B = 2, 24
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# per tensor, relative to that tensor's max |gradient|.  f32: the same
# module on both sides, summation order only.  bf16: both sides recompute
# the plain module with the same rounding points, but each layer takes its
# parameters cast to bf16, so a weight's or bias's gradient is a reduction
# over the rows of bf16 products that each side orders (and rounds) its own
# way, and another f32 summation order can flip a bf16 rounding of an
# activation, which the layers after it carry: measured at most 1.9e-2
# over every bf16 case here; the bound is 10 bf16 ulps (2^-8 each).
GRAD_TOL = {"float32": 2e-5, "bfloat16": 4e-2}


def _mlps(dtype, d_in, seed=0):
    jd, td = DTYPES[dtype]
    jmlp = JResnetFC(d_out=D_OUT, n_blocks=NB, d_latent=D_LAT, d_hidden=H,
                     combine_layer=CL, combine_type="average", dtype=dtype)
    params = jmlp.init(jax.random.PRNGKey(seed),
                       jnp.zeros((2, D_LAT + d_in)))["params"]
    # fc_1 is zero-init; give every weight signal
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(x + 0.05 * jax.random.normal(
            jax.random.PRNGKey(len(jax.tree_util.keystr(path))), x.shape)),
        params)
    tmlp = ResnetFC(d_in, d_out=D_OUT, n_blocks=NB, d_latent=D_LAT,
                    d_hidden=H, combine_layer=CL, dtype=td)
    tmlp.load_state_dict(resnetfc_state_dict(params), strict=True)
    return jmlp, params, tmlp


def _inputs(rng, ns, pe):
    rows = SB * ns * B
    latent = rng.normal(size=(rows, D_LAT)).astype(np.float32)
    if pe:
        x = rng.normal(size=(rows, 6)).astype(np.float32)
        x[:, :3] *= 0.5
    else:
        x = rng.normal(size=(rows, D_ZF)).astype(np.float32)
    g = rng.normal(size=(SB * B, D_OUT)).astype(np.float32)
    return latent, x, g


def _jax_grads(jmlp, params, latent, x, g, ns, dtype, pe, route):
    """(param grads, latent grad, x grad) of <out, g> in JAX: through the
    custom_vjp (route "fused") or flax apply (route "plain")."""
    jd = DTYPES[dtype][0]
    code = JPE(6, 3, 1.5, True)

    def fallback(p, lt, xx):
        zf = jnp.concatenate([code(xx[:, :3]), xx[:, 3:]], axis=-1) \
            if pe else xx
        zx = jnp.concatenate([lt.astype(jnp.float32),
                              zf.astype(jnp.float32)], axis=-1)
        return jmlp.apply({"params": p}, zx,
                          combine_inner_dims=(ns, B)).reshape(-1, D_OUT)

    def f(p, lt, xx):
        if route == "plain":
            out = fallback(p, lt, xx)
        elif pe:
            out = jfm.fused_resnetfc_pe(p, lt, xx, NB, CL, ns, B, jd, FREQS,
                                        fallback)
        else:
            out = jfm.fused_resnetfc(p, lt, xx, NB, CL, ns, B, jd, fallback)
        return jnp.sum(out * g)

    return jax.grad(f, argnums=(0, 1, 2))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(latent),
        jnp.asarray(x))


def _port_grads(tmlp, latent, x, g, ns, dtype, pe):
    td = DTYPES[dtype][1]
    lt = torch.from_numpy(latent).requires_grad_(True)
    xx = torch.from_numpy(x).requires_grad_(True)
    code = PositionalEncoding(6, 3, 1.5, True) if pe else None
    tmlp.zero_grad(set_to_none=True)
    out = field_mlp.fused_field(tmlp, lt, xx, ns, B, td, code)
    assert out.shape == (SB * B, D_OUT) and out.dtype == torch.float32
    fn = field_mlp.FusedResnetFCPE if pe else field_mlp.FusedResnetFC
    assert type(out.grad_fn).__name__ == fn.__name__ + "Backward"
    # the forward keeps the latent, the z-features or base and the
    # parameters, and nothing else
    assert len(out.grad_fn.saved_tensors) == 2 + len(list(tmlp.parameters()))
    (out * torch.from_numpy(g)).sum().backward()
    return ({k: p.grad for k, p in tmlp.named_parameters()}, lt.grad, xx.grad)


def _assert_close(got, ref, tol, what):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, dtype=np.float32)
    assert got.shape == ref.shape, what
    scale = np.abs(ref).max()
    assert scale > 0, what
    err = np.abs(got - ref).max()
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


@pytest.mark.parametrize("route", ["fused", "plain"])
@pytest.mark.parametrize("pe", [True, False], ids=["pe", "zfeat"])
@pytest.mark.parametrize("ns", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_function_grads_match_jax(rng, dtype, ns, pe, route):
    """Gradients w.r.t. every ResnetFC parameter, the latent and the base
    (PE route) or z-features, against jax.grad through the JAX package's
    custom_vjp (route "fused") and through flax apply (route "plain")."""
    d_in = D_PE if pe else D_ZF
    jmlp, params, tmlp = _mlps(dtype, d_in)
    latent, x, g = _inputs(rng, ns, pe)
    jp, jl, jx = _jax_grads(jmlp, params, latent, x, g, ns, dtype, pe, route)
    tp, tl, tx = _port_grads(tmlp, latent, x, g, ns, dtype, pe)
    tol = GRAD_TOL[dtype]
    ref = resnetfc_state_dict(jax.tree.map(np.asarray, jp))
    assert set(ref) == set(tp)
    for name, grad in tp.items():
        _assert_close(grad, ref[name].numpy(), tol, name)
    _assert_close(tl, jl, tol, "latent")
    _assert_close(tx, jx, tol, "base" if pe else "zfeat")


def _graph_nodes(t):
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo += [nxt for nxt, _ in fn.next_functions]
    return {type(fn).__name__ for fn in seen}


def test_model_takes_the_function_only_for_gradients():
    """PixelNeRF.forward goes through FusedResnetFCPE; autograd records
    its node, and saves the tensors its backward needs, only when grad mode
    is on and a field parameter or the latent requires grad.  Under
    no_grad, or when nothing requires grad, no graph is recorded and
    nothing is saved."""
    from pixelnerf_yolo_torch.models import make_model
    from torch_parity import scene, small_flagship

    model = make_model(small_flagship(use_fused_mlp=True)
                       .get_config("model"), device="cpu")
    images, poses, focal = scene(ns=2)
    with torch.no_grad():
        cond = model.encode(images, poses, focal)
    xyz = torch.rand((1, 16, 3)) * 0.2
    vd = torch.nn.functional.normalize(torch.rand((1, 16, 3)), dim=-1)
    saved = []

    def forward():
        saved.clear()
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t) or t, lambda t: t):
            return model.forward(cond, xyz, viewdirs=vd)

    assert "FusedResnetFCPEBackward" in _graph_nodes(forward())
    assert saved
    with torch.no_grad():
        assert forward().grad_fn is None
    assert not saved
    model.requires_grad_(False)
    assert forward().grad_fn is None
    assert not saved


@pytest.mark.parametrize("foreach", [False, True],
                         ids=["for_loop", "foreach"])
@pytest.mark.parametrize("pe", [True, False], ids=["pe", "zfeat"])
def test_kernel_route_follows_an_optimizer_step(rng, pe, foreach):
    """``stacked_params`` is keyed on the parameters' data pointers and
    version counters: after an in-place Adam step the kernel route's
    forward uses the new weights and equals the plain module's.  Adam
    takes its foreach form on CUDA tensors by default, its loop on the
    CPU: both move the version counters."""
    d_in = D_PE if pe else D_ZF
    _, _, tmlp = _mlps("float32", d_in)
    latent, x, g = _inputs(rng, 3, pe)
    code = PositionalEncoding(6, 3, 1.5, True) if pe else None
    lt, xx = torch.from_numpy(latent), torch.from_numpy(x)
    opt = torch.optim.Adam(tmlp.parameters(), lr=1e-2, foreach=foreach)
    before = field_mlp.stacked_params(tmlp, torch.float32)
    out = field_mlp.fused_field(tmlp, lt, xx, 3, B, torch.float32, code)
    (out * torch.from_numpy(g)).sum().backward()
    opt.step()
    assert field_mlp.stacked_params(tmlp, torch.float32) is not before
    with torch.no_grad():
        got = field_mlp.fused_field(tmlp, lt, xx, 3, B, torch.float32, code)
        zf = xx if code is None else field_mlp.pe_features(xx, code)
        ref = field_mlp.plain_field(tmlp, dict(tmlp.named_parameters()), lt,
                                    zf, 3, B)
    assert (got - out.detach()).abs().max() > 1e-3  # the weights moved
    torch.testing.assert_close(got, ref, rtol=0, atol=2e-5 * float(
        ref.abs().max()))
