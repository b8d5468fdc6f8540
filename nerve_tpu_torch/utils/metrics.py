"""Image quality metrics (counterpart of ``nerve_tpu/utils/metrics.py``).

The functions the SR eval step uses, in float32 on the inputs' device:
``mse``, ``psnr``, ``ssim`` (11 × 11 Gaussian window, σ 1.5,
separable, VALID), ``ms_ssim`` (Wang et al. 2003, 2 × 2 average pooling
between levels), ``msssim_levels_for`` and ``vmaf_proxy`` (a 0-100 score
from MS-SSIM and PSNR, not calibrated to libvmaf). Inputs are NHWC in
[0, data_range]; each returns a 0-dim tensor. The temporal metrics (tOF,
tLP) are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Wang et al. (2003) per-scale exponents.
MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred.float() - target.float()) ** 2)


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

