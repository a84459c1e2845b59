"""The port's profiler cut points against the JAX package's named scopes.

JAX's lowered programs carry each op's name stack in its location
(``jax.jit(f).lower(...).as_text(debug_info=True)``:
``jit(f)/renderer_forward/renderer_composite/model_inference/...``).  The
forward paths of a program are those name stacks, outside ``transpose``
(the backward), with only the KNOWN_SCOPES segments kept (a ``jvp(x)``
segment read as x), and every prefix of each.  The port's are the
nestings of its ``record_function`` ranges of those names in a CPU
``torch.profiler`` capture of the same program, outside autograd's
``evaluate_function`` ops (the backward).  The two sets must be equal
for the NeRF render at NS=1 and NS=2, the YOLO render, and one YOLO and
one NeRF update (JAX's lowered through the trainer's
``_update_aval_call``).  Also: the port's KNOWN_SCOPES is JAX's, and a
render exported by ``serve.py`` with the scopes in place still equals
the live render bitwise."""

import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pixelnerf_yolo_torch.utils.profiling import KNOWN_SCOPES
from synth_data import make_srn_dataset, make_yolo_dataset
from torch_parity import (jax_nerf_trainer, jax_yolo_trainer,
                          one_torch_thread, perturbed_variables,  # noqa: F401
                          port_model, port_nerf_trainer, port_yolo_trainer,
                          scene, small_flagship, small_yolo, yolo_scene)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WRAPPED = re.compile(r"(?:[\w]+\()*(\w+)\)*")


def closure(paths):
    out = set()
    for p in paths:
        out.update(p[:i] for i in range(1, len(p) + 1))
    return out


def jax_paths(text):
    """The forward paths of a lowered program's text."""
    paths = set()
    for loc in re.findall(r'loc\("([^"]*)"', text):
        if "/" not in loc or loc.startswith("/") or "transpose(" in loc:
            continue
        segs = []
        for seg in loc.split("/"):
            m = WRAPPED.fullmatch(seg)
            if m and m.group(1) in KNOWN_SCOPES:
                segs.append(m.group(1))
        paths.add(tuple(segs))
    return closure(paths)


def port_paths(fn, tmp_path):
    """The nestings of the KNOWN_SCOPES ranges of a CPU capture of fn(),
    outside the backward."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    by_tid = {}
    for e in events:
        keep = (e.get("cat") == "user_annotation"
                and e["name"] in KNOWN_SCOPES) or e["name"].startswith(
                    "autograd::engine::evaluate_function")
        if keep:
            by_tid.setdefault(e["tid"], []).append(e)
    paths = set()
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []
        for e in evs:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
                stack.pop()
            stack.append(e)
            names = [s["name"] for s in stack]
            if not any(n.startswith("autograd::") for n in names):
                paths.add(tuple(names))
    return paths


def test_known_scopes_are_jax_s():
    spec = importlib.util.spec_from_file_location(
        "jax_profile_trace", os.path.join(REPO, "scripts",
                                          "profile_trace.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert KNOWN_SCOPES == mod.KNOWN_SCOPES


def _nerf_render_paths(ns, tmp_path, fused):
    from pixelnerf_yolo_torch.render import make_renderer
    from pixelnerf_yolo_tpu.models import make_model as jmake_model
    from pixelnerf_yolo_tpu.render import make_renderer as jmake_renderer
    from pixelnerf_yolo_tpu.utils.camera import gen_rays

    conf = small_flagship(use_fused_mlp=fused)
    jm, jr = jmake_model(conf.get_config("model")), jmake_renderer(conf)
    images, poses, focal = scene(ns=ns)
    v = perturbed_variables(jm, images[0])
    jc = jm.encode(v, jnp.asarray(images), jnp.asarray(poses),
                   jnp.asarray(focal))
    rays = np.array(gen_rays(jnp.asarray(poses[0]), 4, 4, jnp.asarray(focal),
                             0.8, 1.8)).reshape(1, -1, 8)
    text = jax.jit(lambda v, r, k: jr(jm, v, jc, r, k)).lower(
        v, jnp.asarray(rays), jax.random.PRNGKey(1)).as_text(debug_info=True)
    tm = port_model(conf, v)
    renderer = make_renderer(conf, device="cpu")
    with torch.no_grad():
        tc = tm.encode(images, poses, focal)
    got = port_paths(lambda: renderer(tm, tc, rays), tmp_path)
    return jax_paths(text), got


@pytest.mark.parametrize("ns,fused", [(1, "false"), (2, "false"),
                                      (1, "true")])
def test_nerf_render_scopes(ns, fused, tmp_path):
    want, got = _nerf_render_paths(ns, tmp_path, fused)
    assert ("renderer_forward", "renderer_composite", "model_inference") \
        in want
    assert got == want


def test_yolo_render_scopes(tmp_path):
    from pixelnerf_yolo_torch.render import make_renderer
    from pixelnerf_yolo_tpu.models import make_model as jmake_model
    from pixelnerf_yolo_tpu.render import make_renderer as jmake_renderer

    conf = small_yolo(use_fused_mlp="false")
    jm, jr = jmake_model(conf.get_config("model")), jmake_renderer(conf)
    images, poses, focal, c, _ = yolo_scene()
    v = perturbed_variables(jm, images[0])
    jc = jm.encode(v, jnp.asarray(images), jnp.asarray(poses),
                   jnp.asarray(focal), c=jnp.asarray(c))
    rays = np.random.default_rng(0).normal(size=(1, 6, 8)).astype(
        np.float32)
    rays[..., 6], rays[..., 7] = 1.0, 3.0
    text = jax.jit(lambda v, r, k: jr(jm, v, jc, r, k)).lower(
        v, jnp.asarray(rays), jax.random.PRNGKey(1)).as_text(
            debug_info=True)
    tm = port_model(conf, v)
    renderer = make_renderer(conf, device="cpu")
    with torch.no_grad():
        tc = tm.encode(images, poses, focal, c=c)
    got = port_paths(lambda: renderer(tm, tc, rays), tmp_path)
    want = jax_paths(text)
    assert ("model_inference", "resnetfc_infer", "resblock") in want
    assert got == want


def test_yolo_update_scopes(tmp_path):
    from pixelnerf_yolo_torch.data import DataLoader, get_split_dataset
    from torch_parity import yolo_train_conf
    from pixelnerf_yolo_torch.config.hocon import parse_string

    root = make_yolo_dataset(str(tmp_path / "data"), n_scenes=1, n_views=4,
                             img_size=64)
    jtr, v = jax_yolo_trainer(root, tmp_path / "j", "false")
    dset = get_split_dataset("yolo", root, conf=yolo_train_conf(
        parse_string, "false"))[0]
    batch = next(iter(DataLoader(dset, batch_size=1)))
    jtr.train_step(batch)
    fn, sds = jtr._update_aval_call
    want = jax_paths(fn.lower(*sds).as_text(debug_info=True))
    tr = port_yolo_trainer(root, tmp_path / "p", v, "false")
    got = port_paths(lambda: tr.train_step(batch), tmp_path)
    assert ("optimizer",) in want and ("encoder_trunk",) in want
    assert got == want


def test_nerf_update_scopes(tmp_path):
    from pixelnerf_yolo_torch.data import DataLoader, get_split_dataset
    from torch_parity import NERF_TRAIN_SIZE

    root = str(tmp_path / "cars")
    for stage in ("train", "val", "test"):
        make_srn_dataset(root, stage=stage)
    jtr, v = jax_nerf_trainer(root, tmp_path / "j", "false", 1)
    dset = get_split_dataset("srn", root, image_size=(NERF_TRAIN_SIZE,
                                                      NERF_TRAIN_SIZE))[0]
    batch = next(iter(DataLoader(dset, batch_size=1)))
    jtr.train_step(batch, 0)
    fn, sds = jtr._update_aval_call
    want = jax_paths(fn.lower(*sds).as_text(debug_info=True))
    tr = port_nerf_trainer(root, tmp_path / "p", v, "false", 1)
    got = port_paths(lambda: tr.train_step(batch, 0), tmp_path)
    assert ("renderer_forward", "renderer_composite", "model_inference",
            "resnetfc_infer", "resblock") in want
    assert got == want


def test_export_round_trip_with_scopes():
    """serve.py's artifact of a render through the kernel ops, loaded
    back, equals the live render bitwise with the cut points in place,
    and its graph holds no profiler op."""
    import io

    from pixelnerf_yolo_torch import serve
    from test_torch_serve_export import _leaves, _nerf_args

    conf = small_flagship("bfloat16")
    fn, model = serve.build_render_fn(conf, device="cpu")
    args = _nerf_args(fn, 2)
    blob = serve.export_render(conf, model, args)
    program = torch.export.load(io.BytesIO(serve._split_artifact(blob)[1]))
    targets = [str(n.target) for n in program.graph.nodes]
    assert any(t.startswith("pixelnerf_yolo.") for t in targets)
    assert not any("profiler" in t or "record_function" in t
                   for t in targets)
    call, _ = serve.load_render(blob)
    with torch.no_grad():
        live = fn(*args)
    for x, y in zip(_leaves(live), _leaves(call(*args))):
        assert torch.equal(x, y)
