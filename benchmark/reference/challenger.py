"""The Fiat-Shamir duplex challenger (overwrite mode, rate 8) over K
transcripts of one shape at once: every call observes or draws the same
number of words in each lane, so one permutation a duplex serves all K.
`duplexes` counts the permutations one transcript took."""

from __future__ import annotations

import numpy as np

from . import poseidon as pos


class Challenger:
    def __init__(self, lanes: int):
        self.state = np.zeros((lanes, pos.WIDTH), dtype=np.uint64)
        self.inputs: list = []  # pending words, each (K,)
        self.outputs: list = []  # words left to draw, each (K,)
        self.duplexes = 0

    def observe(self, words: np.ndarray) -> None:
        """Observe words (K, n) in order."""
        words = np.asarray(words, dtype=np.uint64)
        for i in range(words.shape[1]):
            self.outputs = []
            self.inputs.append(words[:, i])
            if len(self.inputs) == pos.RATE:
                self._duplex()

    def _duplex(self) -> None:
        if self.inputs:
            self.state = self.state.copy()
            self.state[:, : len(self.inputs)] = np.stack(self.inputs, axis=1)
            self.inputs = []
        self.state = pos.permute(self.state)
        self.duplexes += 1
        self.outputs = [self.state[:, i] for i in range(pos.RATE)]

    def challenge(self) -> np.ndarray:
        """The next challenge word of each lane, (K,)."""
        if self.inputs or not self.outputs:
            self._duplex()
        return self.outputs.pop()

    def challenges(self, n: int) -> np.ndarray:
        return np.stack([self.challenge() for _ in range(n)], axis=1)

    def ext_challenge(self) -> np.ndarray:
        """An extension challenge of each lane, (K, 2)."""
        c0 = self.challenge()
        c1 = self.challenge()
        return np.stack([c0, c1], axis=1)
