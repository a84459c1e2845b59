"""RGB and alpha regularization losses.

Counterpart of pixelnerf_yolo_tpu/losses/rgb.py: mean-squared and L1
criteria, the uncertainty- and background-weighted variants, the per-ray
weighted form the NeRF trainer takes, and the Neural Volumes alpha
regularizer.
"""

from __future__ import annotations

import torch


def mse_loss(outputs, targets):
    return torch.mean((outputs - targets) ** 2)


def l1_loss(outputs, targets):
    return torch.mean(torch.abs(outputs - targets))


def _elementwise(use_l1: bool, outputs, targets):
    if use_l1:
        return torch.abs(outputs - targets)
    return (outputs - targets) ** 2


class RGBWithUncertainty:
    """Kendall '17 uncertainty loss: the per-ray error over its beta, plus
    the mean log beta."""

    def __init__(self, conf):
        self.use_l1 = conf.get_bool("use_l1")

    def __call__(self, outputs, targets, betas):
        elem = _elementwise(self.use_l1, outputs, targets)
        weighted = torch.mean(elem, -1) / betas
        return torch.mean(weighted) + torch.mean(torch.log(betas))


class RGBWithBackground:
    """Background-weighted variant: the per-ray error over 1 + lambda_bg,
    plus the mean log lambda_bg."""

    def __init__(self, conf):
        self.use_l1 = conf.get_bool("use_l1")

    def __call__(self, outputs, targets, lambda_bg):
        elem = _elementwise(self.use_l1, outputs, targets)
        weighted = torch.mean(elem, -1) / (1 + lambda_bg)
        return torch.mean(weighted) + torch.mean(torch.log(lambda_bg))


def weighted_rgb_loss(crit, outputs, targets, w, w_total=None):
    """``crit`` with per-ray weights: rays with w = 0 drop out of the mean
    exactly.

    :param outputs/targets (..., R, 3); w (..., R) in {0, 1}, or None
      (``crit`` as it is)
    :param w_total the denominator's weight sum, when the rays are a
      rank's part of a sharded batch (the global sum), else sum(w)
    Only the elementwise criteria (mse_loss, l1_loss) can drop a ray from
    their mean; any other criterion raises TypeError.
    """
    if w is None:
        return crit(outputs, targets)
    if crit is mse_loss:
        elem = (outputs - targets) ** 2
    elif crit is l1_loss:
        elem = torch.abs(outputs - targets)
    else:
        raise TypeError(
            f"weighted_rgb_loss only supports elementwise criteria "
            f"(mse_loss/l1_loss); got {type(crit).__name__}. "
            "loss.rgb.use_uncertainty cannot weight rays; disable it.")
    per_ray = torch.mean(elem, dim=-1)
    total = torch.sum(w) if w_total is None else w_total
    return torch.sum(per_ray * w) / torch.clamp(total, min=1.0)


def get_rgb_loss(conf, coarse=True):
    """The RGB criterion of a ``loss.rgb`` conf: the uncertainty loss for
    the fine pass when ``use_uncertainty``, else L1 or MSE."""
    if conf.get_bool("use_uncertainty", False) and not coarse:
        print("using loss with uncertainty")
        return RGBWithUncertainty(conf)
    print("using vanilla rgb loss")
    return l1_loss if conf.get_bool("use_l1") else mse_loss


class AlphaLossNV2:
    """Neural Volumes alpha regularizer, off before ``init_epoch``.  The
    epoch is an argument."""

    def __init__(self, lambda_alpha, clamp_alpha, init_epoch,
                 force_opaque=False):
        self.lambda_alpha = lambda_alpha
        self.clamp_alpha = clamp_alpha
        self.init_epoch = init_epoch
        self.force_opaque = force_opaque

    def __call__(self, alpha_fine, epoch: int = 0):
        if self.lambda_alpha <= 0.0 or epoch < self.init_epoch:
            return torch.zeros((), device=alpha_fine.device)
        alpha_fine = torch.clamp(alpha_fine, 0.01, 0.99)
        if self.force_opaque:
            # BCE against an all-ones target
            return self.lambda_alpha * torch.mean(-torch.log(alpha_fine))
        alpha_loss = torch.log(alpha_fine) + torch.log(1.0 - alpha_fine)
        alpha_loss = torch.clamp(alpha_loss, min=-self.clamp_alpha)
        return self.lambda_alpha * torch.mean(alpha_loss)


def get_alpha_loss(conf):
    return AlphaLossNV2(
        conf.get_float("lambda_alpha"),
        conf.get_float("clamp_alpha"),
        conf.get_int("init_epoch"),
        force_opaque=conf.get_bool("force_opaque", False),
    )
