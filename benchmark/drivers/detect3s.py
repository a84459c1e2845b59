"""``detect3s``: novel-view detection with a multi-scale head, one client
in a closed loop.  A request is a new scene of source views and one
destination camera: encode, the cell rays of every grid of the
destination view (``gen_rays_yolo_scales``) rendered in one call,
``decode_scales``, ``cross_scale_padded``, ``nms_padded``, the kept boxes
to the host.  A unit is one request; its latency runs from its start to
its boxes on the host.

Set-up imports the program's multi-scale functions first, so that a
program without them fails at once.  Random weights see no objects, and
their boxes are far smaller than their cells, so no grid's box is another
grid's duplicate.  So set-up places lin_out (``_place``) as a detector
that sees one object on every grid at once: the anchors of a ray share
anchor 0's rows, anchor a's width and height biases give a box of the
traffic's ``object_size`` (a fraction of the view) on grid a, and, as
``detect`` does, the objectness biases are shifted until the float32
reference's median calibration scene has ``objects_per_request``
candidates of a size NMS takes above the threshold, counted over every
grid.  ``control=True`` puts the reference, in float8, in the program's
place (``calibrate.py``'s control)."""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import common
from .. import weights as W
from ..reference import multiscale as ms
from ..reference import nets
from ..reference.render import iou, nms
from . import detect
from .detect import CALIBRATION, SIZES, logit, sized


def rows_differ(want: torch.Tensor, got: torch.Tensor) -> int:
    """Rows in which two ordered sets of boxes differ (all of the longer
    where their counts differ)."""
    if want.shape != got.shape:
        return max(want.shape[0], got.shape[0])
    return int((want != got).any(1).sum())


class Driver(detect.Driver):
    def __init__(self, cfg, traffic, seed, device, control: bool = False):
        super().__init__(cfg, traffic, seed, device)
        self.control = control
        S = self.sc["image_size"]
        self.cells = self.y["cell_sizes"]
        self.grids = [(S // cs, S // cs) for cs in self.cells]
        self.n_rays = sum(h * w for h, w in self.grids)
        self.floors = self.y.get("nms_threshold_per_scale")
        self.xs = []

    def _request(self, r: int):
        """(images (1, NS, 3, S, S), extrinsics (NS + 1, 4, 4), the
        destination's last, the coarse draws of every grid's rays) of
        request r."""
        sc, ns = self.sc, self.traffic["ns"]
        rng = np.random.default_rng(common.sub_seed(self.seed, 11, r))
        w2c = torch.as_tensor(common.ring_extrinsics(
            ns + 1, sc["radius"], sc["height"], rng), device=self.device)
        gen = common.generator(self.device, common.sub_seed(self.seed, 12, r))
        images = common.object_images(gen, ns, sc["image_size"], self.device)
        u = torch.rand((self.n_rays, self.K), generator=gen,
                       device=self.device)
        return images[None], w2c, u

    def _reference_out(self, ref, r: int):
        """The reference's (N, A, 7) of request r's rays."""
        sc, ns = self.sc, self.traffic["ns"]
        images, w2c, u = self._request(r)
        cond = ref.encode(images, w2c[None, :ns], self.focal, self.c)
        rays, _ = ms.grid_rays(w2c[ns], sc["image_size"], sc["focal"],
                               self.cells, sc["z_near"], sc["z_far"])
        return ms.render_grids(ref, cond, rays, u, len(self.y["anchors"][0]),
                               self.traffic["check_block_rays"])

    def setup(self):
        from pixelnerf_yolo_torch.detect.nms import (  # noqa: F401
            cross_scale_padded, decode_scales)
        from pixelnerf_yolo_torch.utils.camera import (  # noqa: F401
            gen_rays_yolo_scales)
        from pixelnerf_yolo_torch.config.hocon import Config
        from pixelnerf_yolo_torch.render import make_renderer

        conf = Config(self.cfg["conf"])
        S = self.sc["image_size"]
        self.focal = torch.full((1, 2), self.sc["focal"], device=self.device)
        self.c = torch.full((1, 2), S / 2, device=self.device)
        self.focal2 = np.full(2, self.sc["focal"], np.float32)
        self.c2 = np.full(2, S / 2, np.float32)
        weights = common.benchmark_weights(self.cfg, self.seed, self.device)
        self.placed = self._place(weights)
        if self.control:  # the float8 reference, TF32 off as in the check
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            self.model = common.reference_model(self.cfg, self.device)
            W.load_into(self.model, weights)
            nets.set_lowp(self.model.eval(), "fp8")
        else:
            self.model = common.program_model(self.cfg, weights,
                                              self.device, conf)
            self.renderer = make_renderer(conf, device=self.device)
        del weights
        self.anchors = torch.as_tensor(np.asarray(self.y["anchors"],
                                                  np.float32),
                                       device=self.device)
        for r in range(self.traffic["warmup_requests"]):
            self._serve(10 ** 9 + r)
        self.kept, self.cands, self.xs = [], [], []

    def _place(self, weights: dict) -> dict:
        """Place lin_out in weights (in place) as a detector that sees one
        object on every grid: anchor a's rows are anchor 0's (each keeps
        its objectness bias), its width and height biases make a box of
        ``object_size`` of the view on grid a where the raw output is 0,
        and the objectness biases are shifted as in
        ``detect.Driver._objectness``, over every grid's candidates.
        -> {key: the placed tensor} of lin_out's weight and bias."""
        y, A = self.y, len(self.y["anchors"][0])
        if len(self.grids) != A:
            raise ValueError("one grid an anchor of a ray: "
                             f"{len(self.grids)} grids, {A} anchors")
        wkey = next(k for k in weights if k.endswith("lin_out.weight"))
        self.bias_key = next(k for k in weights
                             if k.endswith("lin_out.bias"))
        weight, bias = weights[wkey], weights[self.bias_key]
        size = self.traffic["object_size"]
        for a, (h, w) in enumerate(self.grids):
            rows = slice(7 * a, 7 * a + 7)
            weight[rows] = weight[:7]
            bias[7 * a + 1:7 * a + 7] = bias[1:7]
            aw, ah = y["anchors"][a][a]
            bias[7 * a + 3] = float(np.log(size * w / aw))
            bias[7 * a + 4] = float(np.log(size * h / ah))
        obj = torch.arange(A, device=self.device) * 7
        bias[obj] -= bias[obj].mean()
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ref = common.reference_model(self.cfg, self.device)
        W.load_into(ref, weights)
        k, levels = self.traffic["objects_per_request"], []
        with torch.no_grad():
            for r in range(self.traffic["calibration_requests"]):
                box, _ = ms.decode_grids(
                    self._reference_out(ref, CALIBRATION + r), self.grids,
                    self.y["anchors"])
                z = logit(box[sized(box), 1]).sort(descending=True)[0]
                if len(z) > k:
                    levels.append(float(z[k - 1] + z[k]) / 2)
                elif len(z):
                    levels.append(float(z[-1]) - 1.0)
        torch.backends.cuda.matmul.allow_tf32 = tf32[0]
        torch.backends.cudnn.allow_tf32 = tf32[1]
        del ref
        if levels:
            bias[obj] += float(logit(torch.tensor(self.y["nms_threshold"]))
                               - np.median(levels))
        common.release()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        return {wkey: weight.clone(), self.bias_key: bias.clone()}

    def _serve(self, r: int):
        from pixelnerf_yolo_torch.detect.nms import (cross_scale_padded,
                                                     decode_scales,
                                                     nms_padded)
        from pixelnerf_yolo_torch.utils.camera import gen_rays_yolo_scales

        y, sc, ns = self.y, self.sc, self.traffic["ns"]
        with torch.no_grad():
            if self.control:
                out, grids = self._reference_out(self.model, r), self.grids
            else:
                images, w2c, u = self._request(r)
                cond = self.model.encode(images, w2c[None, :ns], self.focal,
                                         c=self.c)
                rays, grids = gen_rays_yolo_scales(
                    w2c[ns:], sc["image_size"], sc["image_size"],
                    self.focal2, self.c2, self.cells, sc["z_near"],
                    sc["z_far"])
                out = self.renderer(self.model, cond, rays[0], u=u)
            if self.tracing:
                self.drain()
                t0 = time.perf_counter()
            cand, scale = decode_scales(out[None], grids, self.anchors)
            xs = cross_scale_padded(cand[0], scale, y["cross_scale_nms_iou"],
                                    y["nms_threshold"], self.floors)
            kept, valid = nms_padded(xs, y["nms_iou_threshold"],
                                     y["nms_threshold"],
                                     self.traffic["max_boxes"])
            kept, valid = kept.cpu(), valid.cpu()
        if self.tracing:
            self.detect_spans.append(time.perf_counter() - t0)
        self.kept.append(kept[valid])
        self.cands.append(cand[0])
        self.xs.append(xs)
        self.scale = scale

    def per_unit(self) -> dict:
        from ..flops import reference_flops

        S, ns = self.sc["image_size"], self.traffic["ns"]
        f = reference_flops(self.cfg["conf"], (ns, 3, S, S),
                            self.n_rays * self.K * ns, ns)
        return {"flops": f["encoder"] + f["field"]}

    def numbers(self) -> dict:
        """``detect.Driver.numbers`` over every grid's candidates, with the
        cross-scale pass: of the candidates' [score, x, y, w, h]
        ``cand_exc``; ``class_flips``; ``xscale_mismatch``, the rows in
        which the program's cross-scale survivors differ from the
        reference pass (``multiscale.cross_scale``, float64) on the
        program's candidates; ``nms_mismatch``, the rows in which the kept
        boxes differ from the reference NMS of the program's survivors;
        and ``nms_unmatched``, end to end against the reference's chain on
        its own candidates (``detect._unmatched``'s rule)."""
        y, thr = self.y, self.y["nms_threshold"]
        idx = common.pick(len(self.kept), self.traffic["check_requests"],
                          self.seed)
        cands = [self.cands[i] for i in idx]
        xss = [self.xs[i] for i in idx]
        self.model = self.renderer = None
        self.cands = self.xs = None
        common.release()
        refs = [common.reference_for(self.cfg, self.seed, self.device,
                                     lowp) for lowp in (None, "bf16")]
        for ref in refs:
            params = dict(ref.named_parameters())
            with torch.no_grad():
                for key, value in self.placed.items():
                    params[key].copy_(value)
        xmis = mismatch = passing = dropped = 0
        pairs, margins, classes, ends = [], [], [], []
        with torch.no_grad():
            for i, cand, xs in zip(idx, cands, xss):
                outs = [self._reference_out(ref, i) for ref in refs]
                rc, rc16 = (ms.decode_grids(o, self.grids, y["anchors"])[0]
                            for o in outs)
                pairs.append((cand[:, 1:] - rc[:, 1:],
                              rc16[:, 1:] - rc[:, 1:]))
                margins.append([o.reshape(-1, 7)[:, 5] - o.reshape(-1, 7)[:, 6]
                                for o in outs])
                classes.append((cand[:, 0], rc[:, 0]))
                survivors = xs[torch.isfinite(xs[:, 1])]
                want_x = cand[ms.cross_scale(cand, self.scale,
                                             y["cross_scale_nms_iou"], thr,
                                             self.floors)]
                xmis += rows_differ(want_x, survivors)
                dropped += xs.shape[0] - survivors.shape[0]
                want = nms(survivors, y["nms_iou_threshold"], thr,
                           self.traffic["max_boxes"]).cpu()
                got = self.kept[i]
                mismatch += rows_differ(want, got)
                theirs = ms.detect_index(rc, self.scale,
                                         y["cross_scale_nms_iou"],
                                         y["nms_iou_threshold"], thr,
                                         self.traffic["max_boxes"],
                                         self.floors)
                ends.append((got, cand, rc, rc16, theirs))
                passing += int((cand[:, 1] > thr).sum())
        m_ref = torch.cat([m for m, _ in margins])
        m_rms = torch.sqrt(((torch.cat([m for _, m in margins]) - m_ref)
                            ** 2).mean())
        k = self.traffic["exc_k"]
        clear = m_ref.abs() > k * m_rms
        flips = int(((torch.cat([a for a, _ in classes])
                      != torch.cat([b for _, b in classes])) & clear).sum())
        gaps = torch.cat([a for a, _ in pairs])
        rms = torch.sqrt((torch.cat([b for _, b in pairs]) ** 2).mean(0))
        over = (gaps.abs() > k * rms).any(1)
        z_rms, s_rms = (torch.sqrt(((f(torch.cat([e[3] for e in ends]))
                                     - f(torch.cat([e[2] for e in ends])))
                                    ** 2).mean()) for f in (
            lambda b: logit(b[:, 1]),
            lambda b: b[:, 4:6].double().clamp(min=1e-30).log()))
        counts = np.array([len(kept) for kept in self.kept])
        return {"cand_exc": common.finite(over.float().mean()),
                "class_flips": flips, "xscale_mismatch": xmis,
                "nms_mismatch": mismatch,
                "nms_unmatched": sum(self._unmatched3s(
                    *e, k * z_rms, k * s_rms) for e in ends),
                "xscale_dropped": dropped,
                "passing_share": passing / (len(idx) * rc.shape[0]),
                "kept_boxes": sum(len(self.kept[i]) for i in idx),
                "requests": len(idx),
                "kept_median": float(np.median(counts)),
                "kept_max": int(counts.max()),
                "kept_none_share": float((counts == 0).mean()),
                "objectness_bias": float(self.placed[self.bias_key][0])}

    def _unmatched3s(self, got, cand, rc, rc16, theirs, z_band,
                     s_band) -> int:
        """``detect.Driver._unmatched`` with the reference's kept rows
        ``theirs`` (its cross-scale pass and NMS of its own candidates rc):
        boxes that one side keeps and no box the other keeps matches (IoU
        at least match_iou_threshold), where in the reference the score's
        logit stands clear of the threshold's by more than z_band and the
        log of each size clear of the size bounds' by more than s_band.
        Where a side keeps ``max_boxes`` boxes, the score that ends its
        list is a bound too: which boxes of near that score make the cut is
        rounding's choice, as at the threshold.  A cross-scale or NMS
        choice that rounding turns leaves both boxes matched: their IoU
        passes 0.35 or 0.75, above the match's."""
        y, thr = self.y, self.y["nms_threshold"]
        mine = got.to(device=cand.device, dtype=cand.dtype)
        eq = (cand[None] == mine[:, None]).all(-1)
        log_wh = rc[:, 4:6].double().clamp(min=1e-30).log()
        z = logit(rc[:, 1])
        cuts = [logit(torch.tensor(thr))]
        for rows in (theirs, eq.float().argmax(1)[eq.any(1)]):
            if len(rows) >= self.traffic["max_boxes"]:
                cuts.append(z[rows].min())  # in the reference's scores
        clear = torch.ones_like(z, dtype=torch.bool)
        for cut in cuts:
            clear &= (z - cut).abs() > z_band
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
                print(f"detect3s check: kept by the {name} alone: candidate "
                      f"{j}, program {cand[j].tolist()}, reference "
                      f"{rc[j].tolist()}", file=sys.stderr)
        return int(lone_mine.sum()) + int(lone_theirs.sum())
