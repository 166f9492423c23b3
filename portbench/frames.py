"""Input frames from ``--seed``: every frame distinct, made in bulk.

A pool of ``POOL`` random u8 BGR frames is drawn once on the device from the
seed and copied to the host. Frame ``i`` is pool frame ``i % POOL`` with
``i`` written into its first four bytes (little-endian), so no two frames
of a run are equal and a result cache could not serve one from another; the
reference rebuilds frame ``i`` from the seed the same way.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

POOL = 16


def frame_seed(seed: int) -> int:
    return (int(seed) * 2 + 1) % (2 ** 63)


class Frames:
    def __init__(self, seed: int, hw: Tuple[int, int], device):
        g = torch.Generator(device=device).manual_seed(frame_seed(seed))
        pool = torch.randint(0, 256, (POOL, int(hw[0]), int(hw[1]), 3), generator=g, device=device,
                             dtype=torch.uint8)
        self.pool = pool.cpu().numpy()
        self.hw = (int(hw[0]), int(hw[1]))

    def frame(self, i: int) -> np.ndarray:
        f = self.pool[i % POOL].copy()
        f.reshape(-1)[:4] = np.frombuffer(int(i).to_bytes(4, "little"), np.uint8)
        return f

    def stack(self, indices: Sequence[int]) -> np.ndarray:
        return np.stack([self.frame(i) for i in indices])
