"""The viewer's frame, as frontends/interactive.py's loop makes it:
api.step -> api.render -> .cpu() -> argb_to_rgb, after the mix's key
presses. The check: the last frame's colour and packed bytes at pixels
drawn from the seed against the reference's frames from nonce 0."""

import time

import numpy as np

from portbench import check

KIND = "frames"


class Traffic:
    def __init__(self, mix, config, scene, seed, device, ranks=None):
        from tracer_tpu_torch.engine import api, keys
        from tracer_tpu_torch.utils import image
        self.api, self.image = api, image
        tris, tm, mats = scene
        self.state = api.init(
            int(seed), int(mix["height"]), int(mix["width"]),
            int(mix["sensor_config"]), tris, tm, mats,
            cam_origin=tuple(config["camera"]["origin"]),
            accel=config["accel"], device=device)
        for key in mix.get("keys", []):
            self.state = api.key(keys.KEYDOWN, getattr(keys, "SDLK_" + key),
                                 self.state)
        self.steps = 0
        self.rgb = None

    def call(self, i):
        t0 = time.perf_counter()
        self.state = self.api.step(self.state)
        t1 = time.perf_counter()
        self.rgb = self.image.argb_to_rgb(
            self.api.render(self.state).cpu().numpy())
        t2 = time.perf_counter()
        self.steps += 1
        return {"step_s": t1 - t0, "present_s": t2 - t1}

    def final(self):
        return {"steps": self.steps, "img": self.state.img.cpu().numpy(),
                "rgb": self.rgb}


def numbers(run, settings, want, got=None):
    rng = np.random.default_rng(want.seed)
    pixels = np.sort(rng.choice(run.width * run.height, settings["pixels"],
                                replace=False))
    steps = run.final["steps"]
    img_w, rgb_w = want.viewer(steps, pixels)
    if got is not None:
        img_g, rgb_g = got.viewer(steps, pixels)
    else:
        img_g = run.final["img"].reshape(-1, 3)[pixels]
        rgb_g = run.final["rgb"].reshape(-1, 3)[pixels]
    gaps = check.pixel_gaps(img_g, img_w)
    return {"gap_p90": check.p90(gaps), "off_share": check.off_share(gaps),
            "rgb_off_share": float(np.mean(rgb_g != rgb_w))}


def control_run(run, calls, frames):
    run.final = {"steps": frames}
