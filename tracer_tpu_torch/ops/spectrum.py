"""Piecewise-linear spectra (port of tracer_tpu/ops/spectrum.py).

A spectrum is up to six (wavelength, intensity) knots; unused knots carry
wavelength -1. The device-side lookup is the branch-free knot scan of
the JAX package; the constructors are host-side numpy, copied because
the JAX module imports jax at its top.
"""

from __future__ import annotations

import numpy as np
import torch

RED_WAVELEN = 610.0
GREEN_WAVELEN = 550.0
BLUE_WAVELEN = 460.0

N_KNOTS = 6


def lookup_pairs(v, pairs):
    """Interpolate the knot list [(w_k, x_k), ...] at wavelengths v (N,).

    Nearest knot below (w <= v) and above (w > v); 0 if no knot
    qualifies, clamp to the single neighbour at the ends, ties keep the
    first knot in storage order. Knots may be (N,) tensors or scalars.
    """
    w_below = torch.full_like(v, -1.0)
    x_below = torch.zeros_like(v)
    w_above = torch.full_like(v, float("inf"))
    x_above = torch.zeros_like(v)
    for wk, xk in pairs:
        cb = (wk > w_below) & (wk <= v)
        w_below = torch.where(cb, wk, w_below)
        x_below = torch.where(cb, xk, x_below)
        ca = (wk < w_above) & (wk > v)
        w_above = torch.where(ca, wk, w_above)
        x_above = torch.where(ca, xk, x_above)

    has_below = w_below >= 0.0
    has_above = torch.isfinite(w_above)
    t = (v - w_below) / (w_above - w_below)
    interp = x_below + t * (x_above - x_below)
    zero = torch.zeros_like(v)
    return torch.where(has_below & has_above, interp,
                       torch.where(has_below, x_below,
                                   torch.where(has_above, x_above, zero)))


def lookup_table(v, s):
    """Evaluate a (6, 2) spectrum tensor at wavelengths v (N,)."""
    return lookup_pairs(v, [(s[k, 0], s[k, 1]) for k in range(s.shape[0])])


def uniform_spectrum(intensity: float) -> np.ndarray:
    """Constant spectrum."""
    s = np.full((N_KNOTS, 2), [-1.0, 0.0], dtype=np.float32)
    s[0] = [0.0, intensity]
    return s


def map_intensities(f, s: np.ndarray) -> np.ndarray:
    s = np.array(s, dtype=np.float32)
    s[..., 1] = f(s[..., 1])
    return s


def blackbody(T: float) -> np.ndarray:
    """Planck's-law radiance sampled at 6 wavelengths."""
    c = 299792458.0
    h = 6.62606957e-34
    kb = 1.3806488e-23
    ls_nm = np.array([150.0, BLUE_WAVELEN, GREEN_WAVELEN, RED_WAVELEN,
                      1000.0, 2000.0], dtype=np.float64)
    l = ls_nm * 1e-9
    planck = (2 * h * c * c) / (l ** 5 * (np.exp((h * c) / (l * kb * T)) - 1))
    return np.stack([ls_nm, planck], axis=-1).astype(np.float32)


def _lookup_np(v: float, s: np.ndarray) -> float:
    w, x = s[:, 0], s[:, 1]
    below = (w <= v) & (w > -1.0)
    above = w > v
    if below.any() and above.any():
        wb = w[below].max(); xb = x[below][np.argmax(w[below])]
        wa = w[above].min(); xa = x[above][np.argmin(w[above])]
        return float(xb + (v - wb) / (wa - wb) * (xa - xb))
    if below.any():
        return float(x[below][np.argmax(w[below])])
    if above.any():
        return float(x[above][np.argmin(w[above])])
    return 0.0


def blackbody_normalized(T: float) -> np.ndarray:
    """Blackbody scaled so the Wien-peak wavelength has intensity 1."""
    radiance = blackbody(T)
    wiens_displacement = 2.8977721e-3
    lambda_max_nm = (wiens_displacement / T) * 1e9
    max_radiance = _lookup_np(lambda_max_nm, radiance)
    return map_intensities(lambda i: i / max_radiance, radiance)


def bright_blue_sky() -> np.ndarray:
    return map_intensities(lambda i: i * 5.0, blackbody_normalized(17000.0))


def no_sky() -> np.ndarray:
    return uniform_spectrum(0.0)
