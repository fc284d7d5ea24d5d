"""The offline render, api.sample_n_frames: call i renders samples
i*spp + 1 .. i*spp + spp of every pixel (sample_n_frames(s, spp + 1) on
the state with nonce i*spp, which drops the first frame), then reads
the image. The check: pixels of sampled calls against the reference's
mean of the same samples."""

import dataclasses

import numpy as np

from portbench import check
from portbench.drive import MASK, WARMUP_NONCE

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
        nonce = (WARMUP_NONCE if i is None else i * self.spp) & MASK
        s = dataclasses.replace(self.state, nonce=nonce)
        img = self.api.sample_n_frames(s, self.spp + 1).cpu().numpy()
        return {"nonce": (nonce + 1) & MASK, "out": img}

    def final(self):
        return {}


def numbers(run, settings, want, got=None):
    gaps = []
    for ci, pixels in zip(*check.picks(run, settings, want.seed)):
        nonce = run.calls[ci]["nonce"]
        ref = want.render(nonce, pixels)
        ans = (got.render(nonce, pixels) if got is not None
               else run.calls[ci]["out"].reshape(-1, 3)[pixels])
        gaps.append(check.pixel_gaps(ans, ref))
    gaps = np.concatenate(gaps)
    return {"gap_p90": check.p90(gaps), "off_share": check.off_share(gaps)}


def control_run(run, calls, frames):
    run.calls = [{"nonce": (i * run.spp + 1) & MASK} for i in range(calls)]
