"""Render configuration — the runtime replacement for the reference's
compile-time constants and #if blocks (reference: RayTracingWeekend.cpp:32-43,
199-202; SURVEY.md §5 "Config / flag system")."""
from __future__ import annotations

import dataclasses

LOOP_MODES = ("regen", "tiled", "while", "scan")


@dataclasses.dataclass
class RenderConfig:
    nx: int = 400                 # cpp:35 (100 * size_multiplier)
    ny: int = 400                 # cpp:36
    spp: int = 64                 # subPixelCount, cpp:33
    max_depth: int = 100          # cpp:42
    seed: int = 0
    # Wavefront sizing: samples traced per device launch. Memory per launch
    # scales as nx*ny*samples_per_launch; lower it for huge frames.
    samples_per_launch: int = 8
    # One of LOOP_MODES: "regen" = path-regenerative wavefront (forward
    # default); "tiled" = scatter-free per-pixel slots; "while" = lockstep
    # early-exit loop; "scan" = fixed-depth, reverse-differentiable.
    loop_mode: str = "regen"
    # Framebuffer checkpoint path (native runtime); rerunning the same config
    # resumes accumulation exactly. None disables checkpointing.
    checkpoint: str | None = None

    @property
    def aspect(self) -> float:
        return self.nx / self.ny
