"""``detect``: novel-view detection as the YOLO trainer's ``vis_step``
chains it, one client in a closed loop.  A request is a new scene of
source views and one destination camera: encode, the YOLO render of the
destination's cell rays, ``decode_cells``, ``nms_padded``, the kept boxes
to the host.  A unit is one request; its latency runs from its start to
its boxes on the host.

Random weights detect nothing, and how many of their candidates pass the
score threshold swings with the seed (from none to 40% of them), and
NMS's work with it.  So set-up shifts lin_out's objectness biases, by
one amount for every anchor, until the reference at these weights puts
``objects_per_request`` candidates of a size NMS takes above the
threshold in the median of ``calibration_requests`` scenes that are
never served: on every seed about as many detections as the training
scenes hold objects."""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import common
from .. import weights as W
from ..reference.render import decode, iou, nms, nms_index, render_yolo

CALIBRATION = 2 * 10 ** 9  # request ids of the objectness calibration
SIZES = (1e-3, 1e5)  # the box widths and heights NMS takes lie between


def logit(p: torch.Tensor) -> torch.Tensor:
    """The logit in float64, the score kept off 0 and 1."""
    return torch.logit(p.double().clamp(1e-12, 1 - 1e-12))


def sized(box: torch.Tensor) -> torch.Tensor:
    """(N,) whether the rows' width and height lie where NMS takes them."""
    wh = box[:, 4:6]
    return ((wh > SIZES[0]) & (wh < SIZES[1])).all(1)


def rays_yolo(w2c: torch.Tensor, cells: int, focal: float, c: float,
              near: float, far: float) -> torch.Tensor:
    """(cells * cells, 8) rays of a grid of cells, as the trainer makes
    them (pixel centres at +0.49, directions K^-1 [u, v, 1] turned into
    the world, not normalized); focal and c in cell units."""
    dev = w2c.device
    g = torch.arange(cells, dtype=torch.float32, device=dev) + 0.49
    Y, X = torch.meshgrid(g, g, indexing="ij")
    d = torch.stack([(X - c) / focal, (Y - c) / focal, torch.ones_like(X)],
                    -1)
    inv = torch.linalg.inv(w2c.double()).float()
    d = torch.einsum("ij,hwj->hwi", inv[:3, :3], d).reshape(-1, 3)
    nf = torch.tensor([near, far], device=dev).expand(d.shape[0], 2)
    return torch.cat([inv[:3, 3].expand_as(d), d, nf], -1)


class Driver:
    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.y, self.sc = cfg["conf"]["yolo"], cfg["scene"]
        self.K = cfg["conf"]["renderer"]["n_coarse"]
        self.kept, self.cands = [], []
        self.detect_spans, self.tracing = [], False

    def _request(self, r: int):
        """(images (1, NS, 3, S, S), source extrinsics (1, NS, 4, 4), the
        destination's cell rays, the coarse draws) of request r."""
        sc, ns = self.sc, self.traffic["ns"]
        S, cell = sc["image_size"], self.y["cell_sizes"][0]
        rng = np.random.default_rng(common.sub_seed(self.seed, 11, r))
        w2c = torch.as_tensor(common.ring_extrinsics(
            ns + 1, sc["radius"], sc["height"], rng), device=self.device)
        gen = common.generator(self.device, common.sub_seed(self.seed, 12, r))
        images = common.object_images(gen, ns, S, self.device)
        rays = rays_yolo(w2c[ns], S // cell, sc["focal"] / cell,
                         S / 2 / cell, sc["z_near"], sc["z_far"])
        u = torch.rand((rays.shape[0], self.K), generator=gen,
                       device=self.device)
        return images[None], w2c[None, :ns], rays, u

    def setup(self):
        from pixelnerf_yolo_torch.config.hocon import Config
        from pixelnerf_yolo_torch.render import make_renderer

        conf = Config(self.cfg["conf"])
        S = self.sc["image_size"]
        self.focal = torch.full((1, 2), self.sc["focal"], device=self.device)
        self.c = torch.full((1, 2), S / 2, device=self.device)
        weights = common.benchmark_weights(self.cfg, self.seed, self.device)
        self.bias_key, self.bias = self._objectness(weights)
        self.model = common.program_model(self.cfg, weights, self.device,
                                          conf)
        del weights
        self.renderer = make_renderer(conf, device=self.device)
        self.anchors = torch.as_tensor(np.asarray(self.y["anchors"][0],
                                                  np.float32),
                                       device=self.device)
        for r in range(self.traffic["warmup_requests"]):
            self._serve(10 ** 9 + r)
        self.kept, self.cands = [], []

    def _objectness(self, weights: dict):
        """Shift the objectness biases in weights (in place) so that in the
        float32 reference the median calibration request has the traffic's
        ``objects_per_request`` candidates of a size NMS takes above
        nms_threshold: each request's level halfway between its
        candidates ranked k and k + 1, the shift to the median level.
        -> (the biases' key, the biases)."""
        key = next(k for k in weights if k.endswith("lin_out.bias"))
        y, A = self.y, len(self.y["anchors"][0])
        g = self.sc["image_size"] // y["cell_sizes"][0]
        bias, obj = weights[key], torch.arange(A, device=self.device) * 7
        bias[obj] -= bias[obj].mean()  # logits near 0, where they are exact
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ref = common.reference_model(self.cfg, self.device)
        W.load_into(ref, weights)
        k, levels = self.traffic["objects_per_request"], []
        with torch.no_grad():
            for r in range(self.traffic["calibration_requests"]):
                images, w2c, rays, u = self._request(CALIBRATION + r)
                cond = ref.encode(images, w2c, self.focal, self.c)
                box = decode(render_yolo(ref, cond, rays[None], u, A)[
                    0].reshape(g, g, A, 7), y["anchors"][0])
                z = logit(box[sized(box), 1]).sort(descending=True)[0]
                if len(z) > k:
                    levels.append(float(z[k - 1] + z[k]) / 2)
                elif len(z):
                    levels.append(float(z[-1]) - 1.0)
        torch.backends.cuda.matmul.allow_tf32 = tf32[0]
        torch.backends.cudnn.allow_tf32 = tf32[1]
        del ref, cond
        if levels:
            bias[obj] += float(logit(torch.tensor(y["nms_threshold"]))
                               - np.median(levels))
        common.release()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        return key, bias.clone()

    def _serve(self, r: int):
        from pixelnerf_yolo_torch.detect.nms import decode_cells, nms_padded

        images, w2c, rays, u = self._request(r)
        g = self.sc["image_size"] // self.y["cell_sizes"][0]
        with torch.no_grad():
            cond = self.model.encode(images, w2c, self.focal, c=self.c)
            out = self.renderer(self.model, cond, rays, u=u)
            if self.tracing:
                self.drain()
                t0 = time.perf_counter()
            cand = decode_cells(out.reshape(1, g, g, *out.shape[1:]),
                                self.anchors)[0]
            kept, valid = nms_padded(cand, self.y["nms_iou_threshold"],
                                     self.y["nms_threshold"],
                                     self.traffic["max_boxes"])
            kept, valid = kept.cpu(), valid.cpu()
        if self.tracing:
            self.detect_spans.append(time.perf_counter() - t0)
        self.kept.append(kept[valid])
        self.cands.append(cand)

    def unit(self, i: int):
        self._serve(i)

    def drain(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def end_to_end(self, win) -> dict:
        lat = sorted(win.latencies)
        return {"view_p95_ms": 1e3 * float(np.percentile(lat, 95))}

    def per_unit(self) -> dict:
        from ..flops import reference_flops

        S, ns = self.sc["image_size"], self.traffic["ns"]
        g = S // self.y["cell_sizes"][0]
        f = reference_flops(self.cfg["conf"], (ns, 3, S, S),
                            g * g * self.K * ns, ns)
        return {"flops": f["encoder"] + f["field"]}

    def numbers(self) -> dict:
        """The sampled requests against the reference: of the candidates'
        [score, x, y, w, h] (every cell and anchor), ``cand_exc``, the share
        in which some value is off by more than ``exc_k`` times that
        value's root mean square gap of the reference computed in bfloat16
        (at a bfloat16 computation's rounding points: the rounding it
        cannot avoid) over the sampled requests; the candidates whose
        class differs where the
        reference's class logits stand apart by more than ``exc_k`` times
        the bfloat16 reference's rms gap of that margin; the rows in
        which the kept boxes
        differ from the reference NMS of the same candidates (that stage
        followed from the program's candidates); and, end to end, the
        boxes that one side keeps and the other does not (``_unmatched``:
        the reference's NMS of its own candidates)."""
        idx = common.pick(len(self.kept), self.traffic["check_requests"],
                          self.seed)
        cands = [self.cands[i] for i in idx]
        self.model = self.renderer = None
        self.cands = None
        common.release()
        refs = [common.reference_for(self.cfg, self.seed, self.device,
                                     lowp) for lowp in (None, "bf16")]
        for ref in refs:
            with torch.no_grad():
                dict(ref.named_parameters())[self.bias_key].copy_(self.bias)
        g = self.sc["image_size"] // self.y["cell_sizes"][0]
        A = len(self.y["anchors"][0])
        mismatch, passing = 0, 0
        pairs, margins, classes, ends = [], [], [], []
        with torch.no_grad():
            for i, cand in zip(idx, cands):
                images, w2c, rays, u = self._request(i)
                outs = []
                for ref in refs:
                    cond = ref.encode(images, w2c, self.focal, self.c)
                    outs.append(render_yolo(ref, cond, rays[None], u, A)[0])
                rc, rc16 = (decode(o.reshape(g, g, A, 7),
                                   self.y["anchors"][0]) for o in outs)
                pairs.append((cand[:, 1:] - rc[:, 1:],
                              rc16[:, 1:] - rc[:, 1:]))
                margin = [o.reshape(-1, 7)[:, 5] - o.reshape(-1, 7)[:, 6]
                          for o in outs]
                margins.append(margin)
                classes.append((cand[:, 0], rc[:, 0]))
                want = nms(cand, self.y["nms_iou_threshold"],
                           self.y["nms_threshold"],
                           self.traffic["max_boxes"]).cpu()
                got = self.kept[i]
                ends.append((got, cand, rc, rc16))
                if want.shape != got.shape:
                    mismatch += max(want.shape[0], got.shape[0])
                else:
                    mismatch += int((want != got).any(1).sum())
                passing += int((cand[:, 1] > self.y["nms_threshold"]).sum())
        # a class flip counts where the reference's class logits stand
        # apart by more than exc_k times the bfloat16 reference's rms gap
        # of that margin: beyond what rounding can turn
        m_ref = torch.cat([m for m, _ in margins])
        m_rms = torch.sqrt(((torch.cat([m for _, m in margins]) - m_ref)
                            ** 2).mean())
        clear = m_ref.abs() > self.traffic["exc_k"] * m_rms
        flips = int(((torch.cat([a for a, _ in classes])
                      != torch.cat([b for _, b in classes])) & clear).sum())
        gaps = torch.cat([a for a, _ in pairs])
        rms = torch.sqrt((torch.cat([b for _, b in pairs]) ** 2).mean(0))
        over = (gaps.abs() > self.traffic["exc_k"] * rms).any(1)
        # where rounding can turn NMS's choice: a score's logit or a
        # size's log within exc_k times the bfloat16 reference's rms gap
        # of it from the threshold or a size bound
        z_rms, s_rms = (torch.sqrt(((f(torch.cat([e[3] for e in ends]))
                                     - f(torch.cat([e[2] for e in ends])))
                                    ** 2).mean()) for f in (
            lambda b: logit(b[:, 1]),
            lambda b: b[:, 4:6].double().clamp(min=1e-30).log()))
        k = self.traffic["exc_k"]
        counts = np.array([len(kept) for kept in self.kept])
        return {"cand_exc": common.finite(over.float().mean()),
                "class_flips": flips, "nms_mismatch": mismatch,
                "nms_unmatched": sum(self._unmatched(
                    *e[:3], k * z_rms, k * s_rms) for e in ends),
                "passing_share": passing / (len(idx) * g * g * A),
                "kept_boxes": sum(len(self.kept[i]) for i in idx),
                "requests": len(idx),
                "kept_median": float(np.median(counts)),
                "kept_max": int(counts.max()),
                "kept_none_share": float((counts == 0).mean()),
                "objectness_bias": float(self.bias[0])}

    def _unmatched(self, got, cand, rc, z_band, s_band) -> int:
        """Boxes that one side keeps, the program (got, rows of cand) or
        the reference's NMS of its own candidates rc, and that no box the
        other side keeps matches (IoU at least the configuration's
        match_iou_threshold), where in the reference the score's logit
        stands clear of the threshold's by more than z_band and the log
        of each size clear of the size bounds' by more than s_band:
        beyond what rounding can turn.  A kept row that is no candidate's
        counts wherever it is unmatched."""
        y, thr = self.y, self.y["nms_threshold"]
        mine = got.to(device=cand.device, dtype=cand.dtype)
        eq = (cand[None] == mine[:, None]).all(-1)
        theirs = nms_index(rc, y["nms_iou_threshold"], thr,
                           self.traffic["max_boxes"])
        log_wh = rc[:, 4:6].double().clamp(min=1e-30).log()
        clear = ((logit(rc[:, 1]) - logit(torch.tensor(thr))).abs()
                 > z_band)
        for bound in SIZES:
            clear &= ((log_wh - np.log(bound)).abs() > s_band).all(1)
        hit = iou(mine[:, None, 2:6].float(),
                  rc[theirs, 2:6][None]) >= y["match_iou_threshold"]
        lone_mine = ~hit.any(1) & (clear[eq.float().argmax(1)]
                                   | ~eq.any(1))
        lone_theirs = ~hit.any(0) & clear[theirs]
        for name, rows in (("program", eq.float().argmax(1)[lone_mine]),
                           ("reference", theirs[lone_theirs])):
            for j in rows.tolist():
                print(f"detect check: kept by the {name} alone: candidate "
                      f"{j}, program {cand[j].tolist()}, reference "
                      f"{rc[j].tolist()}", file=sys.stderr)
        return int(lone_mine.sum()) + int(lone_theirs.sum())
