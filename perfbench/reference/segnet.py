"""Plain SegNetBasic training steps (Badrinarayanan et al.; the
reference's models/segnet_basic.py and train_segnet.py:41-94), written
from the configuration: LRN across channels, four levels of 7x7
convolution, batch norm and ReLU with 2x2 max pooling that keeps the
argmax, four levels of unpooling through those positions, convolution and
batch norm, a 1x1 classifier; the softmax cross-entropy over the pixels
whose label is not negative; Adam.  ``torch.nn.functional`` and autograd
in float32 with TF32 off, NCHW, no kernel of the program.  ``tf32=True``
is the control: the same steps with TF32 on.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F


def nearest(masks: np.ndarray, hw) -> np.ndarray:
    """(N, H, W) -> (N, h, w) int32 by cv2's nearest rule,
    src = floor(dst * (src_len / dst_len)) in float32."""
    h, w = masks.shape[-2:]
    oh, ow = hw
    ys = np.clip(np.floor(np.arange(oh, dtype=np.float32)
                          * (np.float32(h) / np.float32(oh))), 0, h - 1)
    xs = np.clip(np.floor(np.arange(ow, dtype=np.float32)
                          * (np.float32(w) / np.float32(ow))), 0, w - 1)
    return masks[:, ys.astype(np.int64)][:, :, xs.astype(np.int64)].astype(
        np.int32)


def inputs(frames: np.ndarray, labels: np.ndarray, hw, cfg: dict, device):
    """Frames (N, H, W, 3) uint8 -> standardized (N, 3, h, w) float32 after
    a float32 bicubic resize; labels (N, h, w) -> int64."""
    x = torch.from_numpy(frames).to(device).permute(0, 3, 1, 2).float()
    x = F.interpolate(x, size=tuple(hw), mode="bicubic", align_corners=False)
    mean = torch.tensor(cfg["standardize"]["mean"], device=device)
    std = torch.tensor(cfg["standardize"]["std"], device=device)
    x = (x - mean[None, :, None, None]) / std[None, :, None, None]
    return x, torch.from_numpy(labels).to(device).long()


def _lrn(x, n, k, alpha, beta):
    half = n // 2
    sq = F.pad(x * x, (0, 0, 0, 0, half, half))
    win = sum(sq[:, i:i + x.shape[1]] for i in range(n))
    return x / (k + alpha * win) ** beta


def _bn(p, name, x, eps):
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
    w, b = p[name + ".weight"], p[name + ".bias"]
    return ((x - mean) / torch.sqrt(var + eps) * w[None, :, None, None]
            + b[None, :, None, None])


def forward(p: dict, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    m = cfg["model"]
    eps, pad = m["bn_eps"], m["kernel"] // 2
    h = _lrn(x, **m["lrn"])
    idxs, sizes = [], []
    for i in range(1, m["levels"] + 1):
        h = torch.relu(_bn(p, f"conv{i}_bn", F.conv2d(
            h, p[f"conv{i}.weight"], padding=pad), eps))
        sizes.append(h.shape[-2:])
        h, idx = F.max_pool2d(h, 2, 2, return_indices=True)
        idxs.append(idx)
    for i in range(m["levels"], 0, -1):
        h = F.max_unpool2d(h, idxs[i - 1], 2, 2, output_size=sizes[i - 1])
        h = _bn(p, f"conv_decode{i}_bn", F.conv2d(
            h, p[f"conv_decode{i}.weight"], padding=pad), eps)
    return F.conv2d(h, p["conv_classifier.weight"], p["conv_classifier.bias"])


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    logp = torch.log_softmax(logits, dim=1)
    valid = labels >= 0
    nll = -logp.gather(1, labels.clamp(min=0)[:, None])[:, 0]
    return (nll * valid).sum() / valid.sum().clamp(min=1)


@contextlib.contextmanager
def _tf32(on: bool):
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def parameters(sd: dict) -> dict:
    return {k: v.detach().clone().float() for k, v in sd.items()
            if k.endswith((".weight", ".bias"))}


def train_steps(sd: dict, cfg: dict, batches: list, tf32: bool = False):
    """Adam steps from ``sd`` on ``batches`` of (images, labels): the
    losses, the first step's gradients and the parameters after the
    last step."""
    opt = cfg["optimizer"]
    b1, b2, lr, eps = opt["beta1"], opt["beta2"], opt["lr"], opt["eps"]
    p = parameters(sd)
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, grad1 = [], None
    with _tf32(tf32):
        for t, (x, y) in enumerate(batches, 1):
            for v in p.values():
                v.requires_grad_(True)
            loss = cross_entropy(forward(p, cfg, x), y)
            grads = torch.autograd.grad(loss, list(p.values()))
            losses.append(float(loss.detach()))
            g = dict(zip(p.keys(), grads))
            if grad1 is None:
                grad1 = {k: x.detach().clone() for k, x in g.items()}
            with torch.no_grad():
                for k in p:
                    m[k] = b1 * m[k] + (1 - b1) * g[k]
                    v2[k] = b2 * v2[k] + (1 - b2) * g[k] * g[k]
                    denom = (v2[k].sqrt() / (1 - b2 ** t) ** 0.5) + eps
                    p[k] = (p[k] - lr / (1 - b1 ** t) * m[k] / denom).detach()
    return {"losses": losses, "grad1": grad1, "params": p}


def gaps(prog: dict, refr: dict, sd: dict) -> dict:
    """Gaps of ``prog`` against ``refr``: each step's relative loss gap
    (``loss_gaps``), the first step's (``loss1_gap``) and the worst
    (``loss_gap``); ``grad_gap`` and ``update_gap`` by the worst leaf."""
    loss_gaps = [abs(a - b) / abs(b)
                 for a, b in zip(prog["losses"], refr["losses"])]
    keys = list(refr["grad1"])
    gr = {k: float(refr["grad1"][k].norm()) for k in keys}
    gp = {k: float(prog["grad1"][k].float().norm()) for k in keys}
    med_g = float(np.median(list(gr.values())))
    grad_gap = max(abs(gp[k] - gr[k]) / max(gr[k], med_g) for k in keys)
    moved = [k for k in keys if gr[k] >= 1e-3 * med_g]
    p0 = parameters(sd)
    dr = {k: float((refr["params"][k] - p0[k]).norm()) for k in moved}
    dp = {k: float((prog["params"][k].float() - p0[k]).norm()) for k in moved}
    med_d = float(np.median(list(dr.values())))
    update_gap = max(abs(dp[k] - dr[k]) / max(dr[k], med_d) for k in moved)
    return {"loss1_gap": loss_gaps[0], "loss_gap": max(loss_gaps),
            "loss_gaps": loss_gaps, "grad_gap": grad_gap,
            "update_gap": update_gap}
