"""The LiDAR capture over a (tile, sample) mesh of ranks,
parallel.render.sample_points_sharded: rows over the tile axis, the spp
budget over the sample axis, the replicas merged by the closest return
(MIN, MAX and SUM all-reduces over each tile's sample group) and the
frame assembled by a SUM over the whole group. The mix's "mesh" is
[n_tile, n_sample], whose product is the cell's chips. Every rank makes
the same call and holds the whole cloud; the entry advances the state's
nonce by spp a call, which sample_points_sharded does not. The check and
the control are sample_points_n's: the same samples, nonce .. nonce +
spp - 1 of every pixel, against the same reference."""

import dataclasses
from pathlib import Path

from portbench import harness
from portbench.drive import MASK, WARMUP_NONCE

KIND = "offline"
_capture = harness.entry("sample_points_n",
                         Path(__file__).resolve().parents[1])
numbers = _capture.numbers
control_run = _capture.control_run


class Traffic(_capture.Traffic):
    def __init__(self, mix, config, scene, seed, device, ranks):
        from tracer_tpu_torch.parallel import render as par
        super().__init__(mix, config, scene, seed, device)
        self.par = par
        # every rank makes the mesh: its sample groups are new_group calls
        self.mesh = par.make_mesh(*mix["mesh"])

    def call(self, i):
        s = (self.state if i is not None else
             dataclasses.replace(self.state, nonce=WARMUP_NONCE))
        pts = self.par.sample_points_sharded(s, self.mesh, self.spp)
        if i is not None:
            self.state = dataclasses.replace(
                s, nonce=(s.nonce + self.spp) & MASK)
        return {"nonce": s.nonce, "out": pts.cpu().numpy()}
