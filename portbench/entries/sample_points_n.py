"""The LiDAR capture, api.sample_points_n: spp samples per pixel from
the state's nonce, which advances by spp a call; reads the points. The
check: points of sampled calls against the reference's closest windowed
return of the same samples (or of a sample tied with it up to rounding);
a pixel with a return on one side alone counts as off."""

import dataclasses

import numpy as np

from portbench import check
from portbench.drive import MASK, WARMUP_NONCE
from portbench.reference import estimator as E

KIND = "offline"


class Traffic:
    def __init__(self, mix, config, scene, seed, device, ranks=None):
        from tracer_tpu_torch.engine import api
        self.api, self.spp = api, int(mix["spp"])
        tris, tm, mats = scene
        self.state = api.init(
            int(seed), int(mix["height"]), int(mix["width"]),
            int(mix["sensor_config"]), tris, tm, mats,
            cam_origin=tuple(config["camera"]["origin"]),
            accel=config["accel"], device=device)

    def call(self, i):
        s = (self.state if i is not None else
             dataclasses.replace(self.state, nonce=WARMUP_NONCE))
        after, pts = self.api.sample_points_n(s, self.spp)
        if i is not None:
            self.state = after
        return {"nonce": s.nonce, "out": pts.cpu().numpy()}

    def final(self):
        return {}


def numbers(run, settings, want, got=None):
    gaps, one_sided = [], []
    for ci, pixels in zip(*check.picks(run, settings, want.seed)):
        nonce = run.calls[ci]["nonce"]
        samples = want.capture_samples(nonce, pixels)
        ans = (got.capture(nonce, pixels) if got is not None
               else run.calls[ci]["out"].reshape(-1, 4)[pixels])
        g, one = check.point_gaps(ans, E.closest_return(*samples),
                                  want.origin, samples)
        gaps.append(g)
        one_sided.append(one)
    gaps = np.concatenate(gaps)
    return {"gap_p90": check.p90(gaps),
            "off_share": check.off_share(gaps, np.concatenate(one_sided))}


def control_run(run, calls, frames):
    run.calls = [{"nonce": (i * run.spp) & MASK} for i in range(calls)]
