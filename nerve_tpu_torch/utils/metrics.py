"""Image quality metrics (counterpart of ``nerve_tpu/utils/metrics.py``).

In float32 on the inputs' device: ``mse``, ``mae``, ``psnr``, ``ssim``
(11 × 11 Gaussian window, σ 1.5, separable, VALID), ``ms_ssim`` (Wang et
al. 2003, 2 × 2 average pooling between levels), ``msssim_levels_for`` and
``vmaf_proxy`` (a 0-100 score from MS-SSIM and PSNR, not calibrated to
libvmaf). Image inputs are NHWC in [0, data_range]; each returns a 0-dim
tensor.

The temporal metrics take (B, T, H, W, C) videos: ``temporal_of`` (the
mean |Δ| of the frame-to-frame differences), ``tof`` (the mean |Δ| of
pyramidal Lucas-Kanade flows, ``lucas_kanade_flow``, of consecutive output
and target frames, in pixels) and ``tlp`` (the change of 1 − SSIM between
consecutive frames, SSIM standing in for LPIPS, as in the JAX package).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Wang et al. (2003) per-scale exponents.
MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred.float() - target.float()) ** 2)


def mae(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred.float() - target.float()))


def psnr(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB."""
    err = mse(pred, target)
    return 10.0 * torch.log10(data_range**2 / torch.clamp(err, min=1e-12))


def _gaussian_kernel(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x**2) / (2.0 * sigma**2))
    return g / torch.sum(g)


def _blur(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Separable VALID Gaussian blur of NCHW ``x``: H pass, then W pass."""
    c = x.shape[1]
    x = F.conv2d(x, g.reshape(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
    return F.conv2d(x, g.reshape(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)


def _moments(p: torch.Tensor, t: torch.Tensor, kernel_size: int, sigma: float):
    """Local means and (co)variances of NHWC float32 ``p``, ``t``; the
    variances clamped at 0 (the blur(x²) − mu² cancellation)."""
    g = _gaussian_kernel(kernel_size, sigma, p.device)
    p, t = p.permute(0, 3, 1, 2), t.permute(0, 3, 1, 2)
    mu_p, mu_t = _blur(p, g), _blur(t, g)
    mu_pp, mu_tt, mu_pt = mu_p * mu_p, mu_t * mu_t, mu_p * mu_t
    sigma_pp = torch.clamp(_blur(p * p, g) - mu_pp, min=0.0)
    sigma_tt = torch.clamp(_blur(t * t, g) - mu_tt, min=0.0)
    sigma_pt = _blur(p * t, g) - mu_pt
    return mu_pp, mu_tt, mu_pt, sigma_pp, sigma_tt, sigma_pt


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Mean structural similarity of (B, H, W, C) images."""
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    mu_pp, mu_tt, mu_pt, s_pp, s_tt, s_pt = _moments(pred.float(), target.float(),
                                                      kernel_size, sigma)
    num = (2 * mu_pt + c1) * (2 * s_pt + c2)
    den = (mu_pp + mu_tt + c1) * (s_pp + s_tt + c2)
    return torch.mean(num / den)


def _ssim_and_cs(p: torch.Tensor, t: torch.Tensor, data_range: float, kernel_size: int,
                 sigma: float):
    """Mean SSIM and mean contrast-structure term (for MS-SSIM levels)."""
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    mu_pp, mu_tt, mu_pt, s_pp, s_tt, s_pt = _moments(p, t, kernel_size, sigma)
    cs = (2 * s_pt + c2) / (s_pp + s_tt + c2)
    lum = (2 * mu_pt + c1) / (mu_pp + mu_tt + c1)
    return torch.mean(lum * cs), torch.mean(cs)


def _pool2(x: torch.Tensor) -> torch.Tensor:
    """2 × 2 VALID average pool of NHWC ``x`` (sum, then / 4)."""
    b, h, w, c = x.shape
    x = x[:, :h // 2 * 2, :w // 2 * 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).sum(dim=(2, 4)) / 4.0


def ms_ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0,
            levels: int = 5, kernel_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Multi-scale SSIM; needs H, W ≥ kernel_size · 2^(levels-1)."""
    weights = MSSSIM_WEIGHTS[:levels]
    weights = tuple(w / sum(weights) for w in weights)
    p, t = pred.float(), target.float()
    vals = []
    for lvl in range(levels):
        s, cs = _ssim_and_cs(p, t, data_range, kernel_size, sigma)
        vals.append(s if lvl == levels - 1 else cs)
        if lvl < levels - 1:
            p, t = _pool2(p), _pool2(t)
    out = torch.ones((), dtype=torch.float32, device=pred.device)
    for v, w in zip(vals, weights):
        out = out * torch.clamp(v, min=0.0) ** w
    return out


def msssim_levels_for(height: int, width: int, kernel_size: int = 11) -> int:
    """The largest MS-SSIM level count that fits an image."""
    levels = 1
    while levels < 5 and min(height, width) >= kernel_size * (2 ** levels):
        levels += 1
    return levels


def vmaf_proxy(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0,
               levels: int = 5) -> torch.Tensor:
    """``100 · (0.8 · ms_ssim + 0.2 · min(psnr, 50) / 50)``: identical frames
    score 100, and the score falls as the distortion grows."""
    m = ms_ssim(pred, target, data_range=data_range, levels=levels)
    p = torch.clamp(psnr(pred, target, data_range=data_range), max=50.0) / 50.0
    return 100.0 * (0.8 * m + 0.2 * p)



def temporal_of(pred_video: torch.Tensor, target_video: torch.Tensor) -> torch.Tensor:
    """The cheap tOF proxy: the mean |Δ| between the frame-to-frame
    differences of the two videos."""
    dp = pred_video[:, 1:] - pred_video[:, :-1]
    dt = target_video[:, 1:] - target_video[:, :-1]
    return torch.mean(torch.abs(dp.float() - dt.float()))


def _to_gray(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) → (..., H, W) luminance (Rec. 601 for three channels)."""
    x = x.float()
    if x.shape[-1] == 3:
        return torch.einsum("...c,c->...", x,
                            torch.tensor([0.299, 0.587, 0.114], device=x.device))
    return x.mean(dim=-1)


def _box(x: torch.Tensor, radius: int) -> torch.Tensor:
    """The (2r + 1)² window sum of (B, H, W) ``x`` (zero beyond the edges),
    over H, then over W."""
    k = 2 * radius + 1
    y = F.conv2d(F.pad(x[:, None], (0, 0, radius, radius)), x.new_ones((1, 1, k, 1)))
    return F.conv2d(F.pad(y, (radius, radius, 0, 0)), x.new_ones((1, 1, 1, k)))[:, 0]


def _lk_level(i1: torch.Tensor, i2: torch.Tensor, flow: torch.Tensor,
              radius: int) -> torch.Tensor:
    """One Lucas-Kanade refinement of the (B, H, W, 2) flow (dx, dy) between
    (B, H, W) grey frames: i2 warped by the flow, central differences of i1
    (wrapping at the edges), the 2 × 2 normal equations over each (2r + 1)²
    window; where their determinant is at most 1e-6 the flow stays."""
    from nerve_tpu_torch.ops.warp import flow_warp

    i2w = flow_warp(i2[..., None], flow)[..., 0]
    ix = (torch.roll(i1, -1, dims=2) - torch.roll(i1, 1, dims=2)) * 0.5
    iy = (torch.roll(i1, -1, dims=1) - torch.roll(i1, 1, dims=1)) * 0.5
    it = i2w - i1
    sxx, sxy, syy = _box(ix * ix, radius), _box(ix * iy, radius), _box(iy * iy, radius)
    sxt, syt = _box(ix * it, radius), _box(iy * it, radius)
    det = sxx * syy - sxy * sxy
    ok = det > 1e-6
    det = torch.where(ok, det, torch.ones_like(det))
    zero = torch.zeros_like(det)
    du = torch.where(ok, -(syy * sxt - sxy * syt) / det, zero)
    dv = torch.where(ok, -(sxx * syt - sxy * sxt) / det, zero)
    return flow + torch.stack([du, dv], dim=-1)


def lucas_kanade_flow(frame1: torch.Tensor, frame2: torch.Tensor, levels: int = 3,
                      radius: int = 3, iters: int = 2) -> torch.Tensor:
    """Pyramidal Lucas-Kanade flow (B, H, W, 2) in pixels (dx, dy) from
    frame1 to frame2 ((B, H, W, C) in [0, 1]; frame1(y, x) ≈ frame2(y + dy,
    x + dx), ``ops.flow_warp``'s convention): coarse to fine, each level
    half the last (bilinear, no antialiasing, at least 8 pixels), no level
    under 32 pixels, ``iters`` refinements a level, the flow resized and
    scaled up between levels."""
    from nerve_tpu_torch.ops.resize import resize_bilinear

    g1, g2 = _to_gray(frame1), _to_gray(frame2)
    _b, h, w = g1.shape
    max_levels = 1
    while min(h, w) // (2 ** max_levels) >= 32 and max_levels < levels:
        max_levels += 1
    pyramid, l1, l2 = [], g1, g2
    for lvl in range(max_levels):
        pyramid.append((l1, l2))
        if lvl < max_levels - 1:
            size = (max(l1.shape[1] // 2, 8), max(l1.shape[2] // 2, 8))
            l1 = resize_bilinear(l1[..., None], size)[..., 0]
            l2 = resize_bilinear(l2[..., None], size)[..., 0]
    flow = torch.zeros(pyramid[-1][0].shape + (2,), dtype=torch.float32, device=g1.device)
    for l1, l2 in reversed(pyramid):
        if flow.shape[1:3] != l1.shape[1:3]:
            scale = torch.tensor([l1.shape[2] / flow.shape[2], l1.shape[1] / flow.shape[1]],
                                 dtype=torch.float32, device=flow.device)
            flow = resize_bilinear(flow, l1.shape[1:3]) * scale
        for _ in range(iters):
            flow = _lk_level(l1, l2, flow, radius)
    return flow


def tof(pred_video: torch.Tensor, target_video: torch.Tensor, levels: int = 3,
        radius: int = 3) -> torch.Tensor:
    """tOF: the mean |flow(pred_t → t+1) − flow(target_t → t+1)| in pixels
    over consecutive frames; 0 for a video whose motion is the target's."""
    t = pred_video.shape[1]
    total = torch.zeros((), dtype=torch.float32, device=pred_video.device)
    for i in range(t - 1):
        fp = lucas_kanade_flow(pred_video[:, i], pred_video[:, i + 1], levels, radius)
        ft = lucas_kanade_flow(target_video[:, i], target_video[:, i + 1], levels, radius)
        total = total + torch.mean(torch.abs(fp - ft))
    return total / max(t - 1, 1)


def tlp(pred_video: torch.Tensor, target_video: torch.Tensor) -> torch.Tensor:
    """The tLP proxy: the mean over consecutive frames of |d(pred_t,
    pred_t+1) − d(target_t, target_t+1)|, d = 1 − SSIM."""
    t = pred_video.shape[1]
    total = torch.zeros((), dtype=torch.float32, device=pred_video.device)
    for i in range(t - 1):
        dp = 1.0 - ssim(pred_video[:, i], pred_video[:, i + 1])
        dt = 1.0 - ssim(target_video[:, i], target_video[:, i + 1])
        total = total + torch.abs(dp - dt)
    return total / max(t - 1, 1)
