"""SDL keycode constants read by engine/api.py:key (the subset of
tracer_tpu/engine/keys.py that the port's key handler uses).

Values are the standard SDL2 keycodes: printable keys are their ASCII
codes, non-printable keys are scancode | 0x40000000 (SDLK_SCANCODE_MASK).
"""

SDLK_SCANCODE_MASK = 1 << 30


def _sc(code):
    return code | SDLK_SCANCODE_MASK


SDLK_SPACE = ord(" ")
SDLK_1 = ord("1")
SDLK_2 = ord("2")
SDLK_a = ord("a")
SDLK_d = ord("d")
SDLK_i = ord("i")
SDLK_k = ord("k")
SDLK_l = ord("l")
SDLK_m = ord("m")
SDLK_n = ord("n")
SDLK_o = ord("o")
SDLK_p = ord("p")
SDLK_s = ord("s")
SDLK_t = ord("t")
SDLK_w = ord("w")
SDLK_x = ord("x")
SDLK_z = ord("z")
SDLK_RIGHT = _sc(79)
SDLK_LEFT = _sc(80)
SDLK_DOWN = _sc(81)
SDLK_UP = _sc(82)

# event codes
KEYDOWN = 0
KEYUP = 1
