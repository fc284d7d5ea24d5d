"""The port's interactive viewer (tracer_tpu_torch/frontends/interactive.py):
the headless loop is the API loop, and a window's key events change the
state as api.key does (pygame with SDL's dummy display)."""

import sys

import numpy as np
import pytest
import torch

from tracer_tpu_torch.engine import api, keys
from tracer_tpu_torch.frontends import interactive
from tracer_tpu_torch.utils import image, testscenes

torch.set_num_threads(2)

W, H = 32, 24


def _state():
    return api.init(0, H, W, 0, *testscenes.cornell_like(),
                    cam_origin=interactive.CAM_ORIGIN, device="cpu")


def _api_loop(s, frames):
    for _ in range(frames):
        s = api.step(s)
    return s, image.argb_to_rgb(api.render(s).numpy())


def test_headless_loop_is_the_api_loop(tmp_path, capsys, monkeypatch):
    """The CLI with --headless: 3 frames give the image of api.step x 3 +
    api.render, without importing pygame."""
    monkeypatch.setitem(sys.modules, "pygame", None)   # import would fail
    out = tmp_path / "view.png"
    state, rgb = interactive.main(["--headless", "-d", "cpu", "-W", str(W),
                                   "-H", str(H), "--frames", "3", "--out",
                                   str(out)])
    want_state, want = _api_loop(_state(), 3)
    assert rgb.shape == (H, W, 3) and rgb.dtype == np.uint8
    np.testing.assert_array_equal(rgb, want)
    assert torch.equal(state.img, want_state.img)
    assert (state.nonce, state.n_frames) == (3, 1)
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    text = capsys.readouterr().out
    assert "Using cpu device: host CPU (id 0)" in text
    assert "3 frames of 32x24" in text and "frames per second" in text


def test_headless_needs_frames():
    with pytest.raises(SystemExit):
        interactive.main(["--headless", "-d", "cpu"])


def test_window_keys_change_the_state_as_api_key(monkeypatch):
    """KEYDOWN w (move), SPACE (accumulation on) and a KEYUP posted to a
    pygame window on SDL's dummy display: the loop's state is
    api.key's, frame for frame."""
    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    pygame = pytest.importorskip("pygame")
    s = _state()
    win = interactive.Window(W, H)
    try:
        for kind, key in ((pygame.KEYDOWN, pygame.K_w),
                          (pygame.KEYDOWN, pygame.K_SPACE),
                          (pygame.KEYUP, pygame.K_w)):
            pygame.event.post(pygame.event.Event(kind, key=key))
        got, rgb, n, _ = interactive.run(s, 2, win)
        pygame.event.post(pygame.event.Event(pygame.KEYDOWN,
                                             key=pygame.K_ESCAPE))
        _, _, n_quit, _ = interactive.run(got, 5, win)
    finally:
        win.close()
    want = api.key(keys.KEYDOWN, keys.SDLK_SPACE,
                   api.key(keys.KEYDOWN, keys.SDLK_w, s))
    want, want_rgb = _api_loop(want, 2)
    assert n == 2 and n_quit == 0
    assert torch.equal(got.cam.origin, want.cam.origin)
    assert not torch.equal(got.cam.origin, s.cam.origin)
    assert got.mode and (got.n_frames, got.nonce) == (2, 2)
    assert torch.equal(got.img, want.img)
    np.testing.assert_array_equal(rgb, want_rgb)
