"""The port's FLOP count: the kernel ops' formulas, the count of a render
by route, the field's share against bench.py's analytic formula, and
``Trainer.update_cost_analysis``.

- Each kernel op (``pixelnerf_yolo::full_pe``, ``pre_combine_pe``,
  ``pre_combine``, ``post_combine``) counts under ``FlopCounterMode``
  exactly what ``FlopCounterMode`` counts for its plain twin on the same
  shapes (3 shape sets, the conv encoder's 128-d latent among them).
- A render through the kernel ops (their CPU kernels run the twins)
  counts exactly what the plain route counts (``count_flops``), and the
  kernels' share is ``profile_trace.field_flops_per_ray`` (bench.py's
  formula on the port model) times the rays the field evaluates; that
  per-ray count equals ``bench.field_flops_per_ray`` on the same conf.
- ``update_cost_analysis()`` is None before a train step; after one it is
  a positive count, it leaves the weights, buffers, gradients and Adam
  state bitwise as they were, and the kernel route's count is at least
  the plain route's (its backward recomputes the plain field)."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import bench
from pixelnerf_yolo_torch import profile_trace as pt
from pixelnerf_yolo_torch.nn.code import PositionalEncoding
from pixelnerf_yolo_torch.nn.resnetfc import ResnetFC
from pixelnerf_yolo_torch.ops import field_mlp as fm
from pixelnerf_yolo_torch.utils.profiling import by_stage, count_flops
from synth_data import make_yolo_dataset
from torch_parity import (one_torch_thread, port_model,  # noqa: F401
                          scene, small_flagship, small_yolo)

# (d_in, d_latent, hidden, d_out): the flagship's PE route at test width,
# the conv encoder's 128-d latent, and the YOLO head's 21 outputs behind
# the viewdirs route's 78-d z-features
SHAPES = [(42, 64, 32, 4), (42, 128, 64, 4), (78, 96, 32, 21)]
ROWS = 37


def flops_of(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def _case(d_in, d_latent, hidden, d_out, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    mlp = ResnetFC(d_in, d_out=d_out, n_blocks=5, d_latent=d_latent,
                   d_hidden=hidden, combine_layer=3, dtype=dtype,
                   generator=g)
    w = fm.stack_params(mlp, dtype)
    code = PositionalEncoding(6, 3)
    base = torch.randn(ROWS, 6, generator=g)
    latent = torch.randn(ROWS, d_latent, generator=g).to(dtype)
    zfeat = torch.randn(ROWS, d_in, generator=g).to(dtype)
    h = torch.randn(ROWS, hidden, generator=g).to(dtype)
    return {
        "full_pe": (lambda: fm.full_pe(base, latent, w, code),
                    lambda: fm.full_pe_plain(base, latent, w, code)),
        "pre_combine_pe": (
            lambda: fm.pre_combine_pe(base, latent, w, code),
            lambda: fm.pre_combine_pe_plain(base, latent, w, code)),
        "pre_combine": (lambda: fm.pre_combine(zfeat, latent, w),
                        lambda: fm.pre_combine_plain(zfeat, latent, w)),
        "post_combine": (lambda: fm.post_combine(h, w),
                         lambda: fm.post_combine_plain(h, w)),
    }


@pytest.mark.parametrize("mode", list(fm.MODES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_op_counts_its_twin(mode, shape):
    d_in, d_latent, hidden, d_out = shape
    if mode.endswith("_pe") and d_in != 42:
        d_in = 42  # the in-kernel PE's z-features: PE(xyz) and viewdirs
    op, twin = _case(d_in, d_latent, hidden, d_out)[mode]
    got, want = flops_of(op), flops_of(twin)
    assert want > 0
    assert got == want


def _renders(conf, ns, n_rays=12):
    """count_flops of one render through the kernel ops and one plain,
    the model, renderer and cond."""
    from pixelnerf_yolo_torch.render import make_renderer
    from pixelnerf_yolo_tpu.models import make_model as jmake_model
    from torch_parity import perturbed_variables

    images, poses, focal = scene(ns=ns)
    v = perturbed_variables(jmake_model(conf.get_config("model")), images[0])
    model = port_model(conf, v)
    renderer = make_renderer(conf, device="cpu")
    with torch.no_grad():
        cond = model.encode(images, poses, focal)
    rays = torch.randn(1, n_rays, 8, generator=torch.Generator()
                       .manual_seed(1))
    rays[..., 6], rays[..., 7] = 0.8, 1.8
    out = {}
    for fused in ("true", "false"):
        model.use_fused_mlp = fused
        out[fused] = count_flops(renderer, model, cond, rays,
                                 generator=torch.Generator().manual_seed(2))
    return out, model, renderer, cond, n_rays


@pytest.mark.parametrize("ns,dtype", [(1, "float32"), (2, "float32"),
                                      (2, "bfloat16")])
def test_kernel_route_render_counts_the_plain_route(ns, dtype):
    conf = small_flagship(dtype)
    out, model, renderer, cond, n_rays = _renders(conf, ns)
    kern, plain = out["true"][1], out["false"][1]
    assert any(op.startswith("pixelnerf_yolo.") for _, op in kern)
    assert not any(op.startswith("pixelnerf_yolo.") for _, op in plain)
    assert sum(kern.values()) == sum(plain.values()) > 0
    field = sum(n for (_, op), n in kern.items()
                if op.startswith("pixelnerf_yolo."))
    per_ray = pt.field_flops_per_ray(model, renderer, ns)
    assert per_ray == bench.field_flops_per_ray(conf, ns)
    assert field == per_ray * pt.field_rays(renderer, cond, n_rays)
    # the field's products are in model_inference on both routes
    assert by_stage(kern)["model_inference"] >= field


def test_yolo_field_count():
    from pixelnerf_yolo_torch.render import make_renderer
    from pixelnerf_yolo_tpu.models import make_model as jmake_model
    from torch_parity import perturbed_variables, yolo_scene

    conf = small_yolo(use_fused_mlp="true")
    images, poses, focal, c, _ = yolo_scene()
    v = perturbed_variables(jmake_model(conf.get_config("model")), images[0])
    model = port_model(conf, v)
    renderer = make_renderer(conf, device="cpu")
    with torch.no_grad():
        cond = model.encode(images, poses, focal, c=c)
    rays = torch.randn(1, 10, 8, generator=torch.Generator().manual_seed(1))
    rays[..., 6], rays[..., 7] = 1.0, 3.0
    counts = {}
    for fused in ("true", "false"):
        model.use_fused_mlp = fused
        counts[fused] = count_flops(renderer, model, cond, rays)[1]
    assert sum(counts["true"].values()) == sum(counts["false"].values())
    field = sum(n for (_, op), n in counts["true"].items()
                if op.startswith("pixelnerf_yolo."))
    per_ray = pt.field_flops_per_ray(model, renderer, 3)
    assert per_ray == bench.field_flops_per_ray(conf, 3)
    assert field == per_ray * pt.field_rays(renderer, cond, 10)


@pytest.fixture(scope="module")
def yolo_root(tmp_path_factory):
    return make_yolo_dataset(str(tmp_path_factory.mktemp("flops")
                                 / "data"), n_scenes=1, n_views=4,
                             img_size=64)


def _trainer(root, tmp_path, fused):
    from pixelnerf_yolo_torch.data import DataLoader, get_split_dataset
    from pixelnerf_yolo_tpu.models import make_model as jmake_model
    from torch_parity import (perturbed_variables, port_yolo_trainer,
                              yolo_train_conf)
    from pixelnerf_yolo_torch.config.hocon import parse_string

    conf = yolo_train_conf(parse_string, fused)
    v = perturbed_variables(jmake_model(conf.get_config("model")),
                            np.zeros((3, 3, 32, 32), np.float32),
                            encoder_stats=True)
    tr = port_yolo_trainer(root, tmp_path, v, fused)
    dset = get_split_dataset("yolo", root, conf=conf)[0]
    return tr, next(iter(DataLoader(dset, batch_size=1)))


def _snapshot(tr):
    import copy

    return ({k: t.clone() for k, t in tr.model.state_dict().items()},
            {k: (None if p.grad is None else p.grad.clone())
             for k, p in tr.model.named_parameters()},
            copy.deepcopy(tr.optimizer.state_dict()),
            tr._gen.get_state().clone(), tr._rng.bit_generator.state)


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def test_update_cost_analysis(yolo_root, tmp_path):
    got = {}
    for fused in ("true", "false"):
        tr, batch = _trainer(yolo_root, tmp_path / fused, fused)
        assert tr.update_cost_analysis() is None
        tr.train_step(batch)
        before = _snapshot(tr)
        ca = tr.update_cost_analysis()
        assert set(ca) == {"flops"} and ca["flops"] > 0
        assert _same(_snapshot(tr), before)
        got[fused] = ca["flops"]
        # the count is of the update the step took: the same again
        assert tr.update_cost_analysis() == ca
    assert got["true"] >= got["false"]
