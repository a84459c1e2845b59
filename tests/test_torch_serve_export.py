"""The port's serving export (pixelnerf_yolo_torch/serve.py) on the CPU:
an exported and reloaded render equals the live one bitwise (NeRF and
YOLO), carries the model's weights and the field kernels' custom ops, and
refuses what is not an artifact or not its arguments; the CLI writes an
artifact.  The render itself is held against the JAX package in
tests/test_torch_model.py and tests/test_torch_yolo.py."""

import io
import json

import pytest
import torch

from pixelnerf_yolo_torch import serve
from pixelnerf_yolo_torch.ops import field_mlp
from pixelnerf_yolo_torch.utils.camera import gen_rays, gen_rays_yolo
from torch_parity import scene, small_flagship, small_yolo, yolo_scene


def _nerf_args(fn, ns=1):
    images, poses, focal = scene(ns=ns)
    images, poses = torch.from_numpy(images), torch.from_numpy(poses)
    focal = torch.tensor(focal)
    rays = gen_rays(poses[0, :1], 8, 8, focal, 0.8, 1.8).reshape(1, -1, 8)
    draws = serve.make_draws(fn, images, rays,
                             torch.Generator().manual_seed(0))
    return (images, poses, focal, rays, *draws)


def _yolo_args(fn):
    images, poses, focal, c, target = yolo_scene(ns=3)
    rays = gen_rays_yolo(torch.from_numpy(target), 8, 8,
                         torch.from_numpy(focal[0] / 8),
                         torch.from_numpy(c[0] / 8), 1.0,
                         3.0).reshape(1, -1, 8)[:, :40]
    images, poses = torch.from_numpy(images), torch.from_numpy(poses)
    draws = serve.make_draws(fn, images, rays,
                             torch.Generator().manual_seed(0))
    return (images, poses, torch.from_numpy(focal), rays, *draws)


CASES = {  # name: (conf, args, kernel ops of the exported graph)
    "nerf_ns1": (lambda: small_flagship(), lambda fn: _nerf_args(fn, 1),
                 {"full_pe": 2}),
    "nerf_ns2_bf16": (lambda: small_flagship("bfloat16"),
                      lambda fn: _nerf_args(fn, 2),
                      {"pre_combine_pe": 2, "post_combine": 2}),
    "yolo_bf16": (lambda: small_yolo("bfloat16"), _yolo_args,
                  {"pre_combine_pe": 1, "post_combine": 1}),
    "nerf_plain": (lambda: small_flagship(use_fused_mlp="false"),
                   lambda fn: _nerf_args(fn, 1), {}),
}


@pytest.fixture(scope="module", params=list(CASES))
def exported(request):
    make_conf, make_args, ops = CASES[request.param]
    conf = make_conf()
    fn, model = serve.build_render_fn(conf, device="cpu")
    args = make_args(fn)
    blob = serve.export_render(conf, model, args)
    return request.param, fn, model, args, blob, ops, serve.load_render(blob)


def _leaves(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for branch in out.values() for t in branch.values()]


def test_round_trip_is_bitwise(exported):
    name, fn, _, args, _, _, (call, header) = exported
    assert header["mode"] == ("yolo" if name.startswith("yolo") else "nerf")
    assert header["device"] == "cpu"
    with torch.no_grad():
        live = fn(*args)
    field_mlp.reset_launches()
    got = call(*args)
    launches = sum(field_mlp.launches.values())
    assert launches == 0  # the CPU runs the kernels' plain twins
    a, b = _leaves(live), _leaves(got)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert torch.equal(x, y)
        assert bool(torch.isfinite(x).all())


def test_exported_graph_holds_the_kernel_ops(exported):
    _, _, _, _, blob, ops, _ = exported
    program = torch.export.load(io.BytesIO(serve._split_artifact(blob)[1]))
    found = {}
    for node in program.graph.nodes:
        target = str(node.target)
        if target.startswith("pixelnerf_yolo."):
            op = target.split(".")[1]
            found[op] = found.get(op, 0) + 1
    assert found == ops
    # the kernels' stacked weights are constants of the program
    if ops:
        assert len(program.constants) >= 14


def test_baked_weights(exported):
    _, _, model, _, blob, _, _ = exported
    weights = serve.load_weights_from_artifact(blob)
    state = {k: t for k, t in model.state_dict().items()}
    params = dict(model.named_parameters())
    assert {k for k in weights if k.startswith("model.")} >= {
        "model." + k for k in params}
    for k, t in params.items():
        assert torch.equal(weights["model." + k], t.detach()), k
    assert set(state) >= {k[len("model."):] for k in weights}


def test_header_and_argument_checks(exported):
    _, fn, _, args, blob, _, (call, header) = exported
    with pytest.raises(ValueError, match="not a pixelnerf_yolo_torch"):
        serve.load_render(b"PNYEXPORT1\n" + blob[20:])
    header, rest = serve._split_artifact(blob)
    bad = json.dumps({**header, "format": 99}).encode()
    with pytest.raises(ValueError, match="format"):
        serve.load_render(serve._MAGIC + len(bad).to_bytes(8, "big") + bad
                          + rest)
    names = [a[0] for a in header["args"]]
    assert names[:4] == ["images", "poses", "focal", "rays"]
    assert names[4:] == list(fn.draw_names())
    with pytest.raises(ValueError, match="rays"):
        call(*args[:3], args[3][:, :-1], *args[4:])
    with pytest.raises(ValueError, match="arguments"):
        call(*args[:-1])


def _hocon(d, indent=""):
    """A conf dict as HOCON text (strings quoted, lists as JSON)."""
    lines = []
    for k, v in d.items():
        if isinstance(v, dict):
            lines += [f"{indent}{k} {{", _hocon(v, indent + "  "),
                      f"{indent}}}"]
        else:
            lines.append(f"{indent}{k} = {json.dumps(v)}")
    return "\n".join(lines)


def _conf_file(tmp_path):
    path = tmp_path / "small.conf"
    path.write_text(_hocon(small_flagship().to_dict()))
    return path


def test_cli_writes_an_artifact(tmp_path):
    path = _conf_file(tmp_path)
    out = tmp_path / "small.pnyt"
    serve._cli(["--conf", str(path), "--init-weights", "--rays", "64",
                "--size", "32", "--device", "cpu", "--out", str(out)])
    call, header = serve.load_render(out.read_bytes())
    assert header["args"][3] == ["rays", [1, 64, 8], "float32"]
    assert header["args"][0] == ["images", [1, 1, 3, 32, 32], "float32"]
    with pytest.raises(SystemExit):  # weights are required
        serve._cli(["--conf", str(path), "--device", "cpu", "--out",
                    str(out)])


def test_cli_bakes_a_checkpoint(tmp_path):
    path = _conf_file(tmp_path)
    _, model = serve.build_render_fn(small_flagship(), device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.5)
    ck = tmp_path / "checkpoints" / "run"
    ck.mkdir(parents=True)
    torch.save(model.state_dict(), ck / "pixel_nerf_latest")
    out = tmp_path / "ck.pnyt"
    serve._cli(["--conf", str(path), "--checkpoint", str(ck), "--rays",
                "64", "--size", "32", "--device", "cpu", "--out", str(out)])
    weights = serve.load_weights_from_artifact(out.read_bytes())
    for k, t in model.named_parameters():
        assert torch.equal(weights["model." + k], t.detach()), k
