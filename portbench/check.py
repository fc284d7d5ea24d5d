"""The comparison that decides `correct`: answers of the window, drawn
from the seed, against the plain reference (reference/estimator.py) at
the same sizes, seed, nonces and pixels. The entry of the cell's mix
(entries/<entry>.py) says which answers and which numbers; the gaps and
their statistics are here.

A gap is relative:
  image pixel  max over channels |program - reference| / max(largest
               reference channel, 1e-4)
  point        the larger of |position gap| / distance from the camera
               and |intensity gap| / reference intensity, where both
               sides return, the least over the reference's samples
               whose distances tie with the closest return's up to
               rounding (TIE), since the program may pick any of them;
               a pixel with a return on one side only is counted apart
               (one_sided) and has no gap
Each entry holds the 90th percentile (nearest rank) of its sampled
gaps, gap_p90, and off_share: the share of its sampled answers whose gap
passes OFF or that return on one side only. A rare sample whose path
branches the other way on a last-bit difference moves one answer by
1e-3 or so (one of 128 in a sound run, PERF.md); a fault confined to a
few percent of the answers moves several.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import estimator as E

FLOOR = np.float32(1e-4)
# Samples whose return distances lie within this share of a pixel's
# least are tied: the program's and the reference's distances differ by
# a few f32 ulps, so either may win the pixel.
TIE = 1e-6
OFF = 1e-4          # a gap past this, the gap_p90 limit, is an answer off


def p90(gaps) -> float:
    """The 90th percentile of the gaps (nearest rank)."""
    g = np.sort(np.asarray(gaps, np.float64).ravel())
    if g.size == 0:
        return float("inf")
    return float(g[int(np.ceil(0.9 * g.size)) - 1])


def off_share(gaps, one_sided=None) -> float:
    """The share of answers whose gap passes OFF (or is NaN), or that
    return on one side only."""
    g = np.asarray(gaps, np.float64).ravel()
    if g.size == 0:
        return float("inf")
    off = ~(g <= OFF)
    if one_sided is not None:
        off |= np.asarray(one_sided, bool).ravel()
    return float(off.mean())


def pixel_gaps(got, want):
    """(P,) relative gaps of (P, 3) colours."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.maximum(np.abs(want).max(axis=1), FLOOR)
    gap = np.abs(got - want).max(axis=1) / den
    return np.where(np.isfinite(gap), gap, np.inf)


def _point_gap(got, want, origin):
    dist = np.linalg.norm(want[:, :3] - np.asarray(origin), axis=1)
    pos = np.linalg.norm(got[:, :3] - want[:, :3], axis=1) / np.maximum(
        dist, 1e-3)
    inten = np.abs(got[:, 3] - want[:, 3]) / np.maximum(np.abs(want[:, 3]),
                                                        1e-30)
    return np.maximum(pos, inten)


def point_gaps(got, want, origin, samples=None):
    """((P,) relative gaps of (P, 4) points [x, y, z, intensity], 0 where
    neither side returns and where one side alone does, (P,) bool: one
    side alone returns). samples: the reference's (distances (S, P),
    points (S, P, 4)) per sample (estimator.capture_samples), whose ties
    with the closest return each pixel's gap may take instead."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    has_g, has_w = got[:, 3] > 0, want[:, 3] > 0
    gap = _point_gap(got, want, origin)
    if samples is not None:
        best, pts = samples
        d_min = best.min(axis=0).astype(np.float64)
        for d, p in zip(best, np.asarray(pts, np.float64)):
            tied = np.isfinite(d) & (d <= d_min * (1.0 + TIE))
            gap = np.where(tied, np.fmin(gap, _point_gap(got, p, origin)),
                           gap)
    gap = np.where(has_g & has_w, gap, 0.0)
    return np.where(np.isnan(gap), np.inf, gap), has_g != has_w


def picks(run, settings: dict, seed: int):
    """(call indices, pixels per call) drawn from the seed: the last
    call and settings["calls"] - 1 others, settings["pixels"] pixels
    of each."""
    rng = np.random.default_rng(int(seed))
    n_calls = len(run.calls)
    n_pix = run.width * run.height
    others = rng.permutation(max(n_calls - 1, 0))[:settings["calls"] - 1]
    calls = sorted(set(others.tolist()) | {n_calls - 1})
    pixels = [np.sort(rng.choice(n_pix, settings["pixels"], replace=False))
              for _ in calls]
    return calls, pixels


class Reference:
    """The reference's answers for a cell's configuration and mix at a
    seed, in `precision` ("tf32" is the control)."""

    def __init__(self, config: dict, mix: dict, scene_arrays, seed: int,
                 device, precision="float32"):
        self.sensor = E.SENSORS[int(mix["sensor_config"])]
        self.origin = tuple(config["camera"]["origin"])
        self.scene = E.Scene(*scene_arrays, device=device,
                             precision=precision)
        self.seed = int(seed)
        self.w, self.h, self.spp = (int(mix["width"]), int(mix["height"]),
                                    int(mix["spp"]))

    def render(self, nonce, pixels):
        """The mean colour of samples nonce .. nonce + spp - 1."""
        with np.errstate(all="ignore"):
            return E.render_pixels(self.scene, self.sensor, self.origin,
                                   self.seed, nonce, self.spp, pixels,
                                   self.w, self.h)

    def capture(self, nonce, pixels):
        """The points of samples nonce .. nonce + spp - 1."""
        return E.closest_return(*self.capture_samples(nonce, pixels))

    def capture_samples(self, nonce, pixels):
        """Each sample's (distance, point) of nonce .. nonce + spp - 1."""
        with np.errstate(all="ignore"):
            return E.capture_samples(self.scene, self.sensor, self.origin,
                                     self.seed, nonce, self.spp, pixels,
                                     self.w, self.h)

    def viewer(self, frames, pixels):
        """(colour, packed bytes) after `frames` 1-spp frames."""
        with np.errstate(all="ignore"):
            return E.viewer_pixels(self.scene, self.sensor, self.origin,
                                   self.seed, frames, pixels, self.w,
                                   self.h)


def compare(run, settings: dict, config: dict, mix: dict, scene_arrays,
            seed: int, device, control=None, base=None) -> dict:
    """{number: (value, limit)} for the run's sampled answers against
    the reference at float32. control: a Reference whose answers stand
    in for the program's, to read the control."""
    from portbench import harness
    entry = harness.entry(run.entry, base or harness.HERE)
    want = Reference(config, mix, scene_arrays, seed, device)
    vals = entry.numbers(run, settings, want, control)
    limits = settings["limits"]
    return {k: (v, float(limits[k])) for k, v in vals.items()}


def correct(numbers: dict) -> bool:
    return all(np.isfinite(v) and v <= lim for v, lim in numbers.values())
