"""Interactive viewer (port of frontends/interactive.py, the reference's
demo-interactive/liblys.c).

    python -m tracer_tpu_torch.frontends.interactive [-o OBJ] [-W 800] \\
        [-H 600] [-c 0] [-d cuda] [--frames N] [--out PNG] [--headless]

Per frame: step -> render -> utils/image.argb_to_rgb -> blit, with key
events forwarded to api.key (the engine reads the keycodes,
liblys.c:104-123) and resizes to api.resize. Keymap (README.org:54-67):
WASD/XZ move, arrows look, SPACE/n/m accumulation, 1/2 subsampling, i/k
aperture, o/l focal distance, t sensor config, p sky; ESC quits.

The scene is -o, else CornellBox-Original.obj under $TRACER_ASSETS when
it is there, else the procedural Cornell box (as save_demo chooses). -d
takes cuda, cuda:N or cpu; the default is the card. pygame is imported
only where a window opens: --headless runs the same loop with no window
and no pygame, for --frames frames, and prints frames per second.
"""

from __future__ import annotations

import argparse
import time

from tracer_tpu_torch.engine import api, keys
from tracer_tpu_torch.frontends.save_demo import CAM_ORIGIN, load_scene
from tracer_tpu_torch.utils import image

FPS_EVERY = 32   # frames between two frames-per-second reports


class Window:
    """A pygame window: quit, key and resize events out, frames in."""

    def __init__(self, w: int, h: int):
        import pygame
        self.pygame = pygame
        pygame.display.init()
        self.screen = pygame.display.set_mode((w, h))
        pygame.display.set_caption("tracer_tpu_torch")

    def events(self):
        """("quit",), ("key", keys.KEYDOWN | keys.KEYUP, keycode) or
        ("resize", h, w) for each pending event; pygame's keycodes are
        SDL2's, which api.key reads."""
        pg = self.pygame
        for ev in pg.event.get():
            if ev.type == pg.QUIT or (ev.type == pg.KEYDOWN
                                      and ev.key == pg.K_ESCAPE):
                yield ("quit",)
            elif ev.type in (pg.KEYDOWN, pg.KEYUP):
                yield ("key", keys.KEYDOWN if ev.type == pg.KEYDOWN
                       else keys.KEYUP, ev.key)
            elif ev.type == pg.VIDEORESIZE:
                yield ("resize", ev.h, ev.w)

    def show(self, rgb, caption=None):
        surf = self.pygame.surfarray.make_surface(rgb.swapaxes(0, 1))
        self.screen.blit(surf, (0, 0))
        self.pygame.display.flip()
        if caption:
            self.pygame.display.set_caption(caption)

    def close(self):
        self.pygame.display.quit()


def run(state, frames: int = 0, window: Window | None = None):
    """The viewer's loop from `state`: until quit, or for `frames` frames
    when frames > 0. Returns (state, the last frame (h, w, 3) uint8,
    frames run, seconds)."""
    n, rgb = 0, None
    t0 = t_report = time.perf_counter()
    while not frames or n < frames:
        for ev in (window.events() if window is not None else ()):
            if ev[0] == "quit":
                return state, rgb, n, time.perf_counter() - t0
            if ev[0] == "key":
                state = api.key(ev[1], ev[2], state)
            else:
                state = api.resize(ev[1], ev[2], state)
        state = api.step(state)
        rgb = image.argb_to_rgb(api.render(state).cpu().numpy())
        n += 1
        caption = None
        if n % FPS_EVERY == 0:
            now = time.perf_counter()
            caption = (f"tracer_tpu_torch - {FPS_EVERY / (now - t_report):.1f}"
                       f" fps, {state.n_frames} accumulated")
            t_report = now
        if window is not None:
            window.show(rgb, caption)
    return state, rgb, n, time.perf_counter() - t0


def device_banner(device) -> str:
    """The liblys.c:195-207 "Using OpenCL device" line."""
    import torch
    index = device.index or 0
    name = (torch.cuda.get_device_name(index) if device.type == "cuda"
            else "host CPU")
    return f"Using {device.type} device: {name} (id {index})"


def main(argv=None):
    ap = argparse.ArgumentParser(description="tracer_tpu_torch viewer")
    ap.add_argument("-o", "--obj", default=None)
    ap.add_argument("-W", "--width", type=int, default=800)
    ap.add_argument("-H", "--height", type=int, default=600)
    ap.add_argument("-c", "--conf", type=int, default=0,
                    help="sensor config id (0 visual, 1 flash, 2 lidar)")
    ap.add_argument("--frames", type=int, default=0,
                    help="render N frames then exit (0 = run until quit)")
    ap.add_argument("--out", default=None, help="PNG path on exit")
    ap.add_argument("--headless", action="store_true",
                    help="no window and no pygame; needs --frames")
    ap.add_argument("-d", "--device", default="cuda",
                    help="cuda, cuda:N or cpu (the reference viewer's -d)")
    args = ap.parse_args(argv)
    if args.headless and args.frames <= 0:
        ap.error("--headless needs --frames N")

    import torch
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card; pass -d cpu to run on the CPU")
    (tris, tm, mats), name = load_scene(args.obj)
    print(f"scene {name}: {tris.shape[0]} triangles")
    print(device_banner(device))
    print("Use -d to change this.")
    state = api.init(0, args.height, args.width, args.conf, tris, tm, mats,
                     cam_origin=CAM_ORIGIN, device=device)

    window = None if args.headless else Window(args.width, args.height)
    try:
        state, rgb, n, secs = run(state, args.frames, window)
    finally:
        if window is not None:
            window.close()
    print(f"{n} frames of {args.width}x{args.height} in {secs:.3f} s: "
          f"{n / secs:.2f} frames per second on {device}")
    if args.out and rgb is not None:
        image.write_png(args.out, rgb)
        print(f"wrote {args.out}")
    return state, rgb


if __name__ == "__main__":
    main()
