"""The one generator of traffic: a mix's data file and a seed make a plan.

A mix (``traffic/<name>.json``) is sent by a closed loop of one client: it
sends a study, waits for its answers, and sends the next. A study is the
mix's list of calls. What the seed draws, the plan holds:

* the key of every study (study ``i`` has ``key(i)``; the warm-up study its
  own key), which each call hands the port as its ``key=``;
* the seed of each input's generator;
* one generator per judged call, from which its reference draws samples.

Every seed gets the same sizes and the same calls; only the keys and the
draws differ.
"""

from __future__ import annotations

import zlib

import numpy as np

#: keys are non-negative 63-bit ints: every ``torch.Generator`` seed range
KEY_MASK = 2**63 - 1


def derive(seed: int, *path: int) -> int:
    """A 63-bit integer drawn from ``seed`` along ``path``."""
    words = np.random.SeedSequence([int(seed) & (2**64 - 1), *path])
    return int(words.generate_state(1, dtype=np.uint64)[0]) & KEY_MASK


class Plan:
    """What one seed draws for one mix."""

    def __init__(self, traffic: dict, seed: int):
        self.traffic = traffic
        self.seed = int(seed)

    def key(self, study: int) -> int:
        return derive(self.seed, 1, study)

    @property
    def warmup_key(self) -> int:
        return derive(self.seed, 0)

    def input_seed(self, name: str) -> int:
        """The seed of input ``name``'s generator."""
        return derive(self.seed, 3, zlib.crc32(name.encode()))

    def rng(self, call: str) -> np.random.Generator:
        """The generator from which ``call``'s reference draws samples."""
        return np.random.default_rng(derive(self.seed, 4,
                                            zlib.crc32(call.encode())))
