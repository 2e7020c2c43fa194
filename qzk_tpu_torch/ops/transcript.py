"""Fiat-Shamir challenger — Poseidon duplex sponge (host side).

Deterministic transcript: every challenge is a pure function of the
observations so far, which is what makes proving reproducible (the
reference pins the `no_random` feature of its engine for exactly this —
SURVEY.md §2b row "no_random").  Semantics (documented here as the
normative spec for this stack; the in-circuit challenger for recursion
must replicate it exactly):

  * state: width-12 Poseidon state, initially zero.
  * observe(e..): appends to an input buffer; when 8 elements accumulate
    the sponge duplexes (overwrite state[0:k] with the buffered k
    elements, permute).  Observing clears any pending output buffer.
  * challenge: if observations are pending or the output buffer is
    empty, duplex; then pop the LAST element of the output buffer
    (state[0:8] snapshot).
"""

from __future__ import annotations

import numpy as np

from . import goldilocks as gl
from . import poseidon


class Challenger:
    def __init__(self):
        self.state = np.zeros(poseidon.WIDTH, dtype=np.uint64)
        self.input_buf: list[int] = []
        self.output_buf: list[int] = []

    # -- observations -------------------------------------------------------

    def observe_element(self, e) -> None:
        self.output_buf.clear()
        self.input_buf.append(np.uint64(e))
        if len(self.input_buf) == poseidon.RATE:
            self._duplex()

    def observe_elements(self, elements) -> None:
        arr = np.asarray(elements, dtype=np.uint64).ravel()
        if arr.size == 0:
            return
        # bulk absorb in one native call (overwrite-mode semantics are
        # identical: elements land in state[:k] exactly as the
        # per-element duplex would place them); fall back to the
        # element loop when the native library is unavailable
        from .. import native

        if self.state.flags.c_contiguous:
            k0 = len(self.input_buf)
            if k0:
                # pending elements live in the python buffer; the C
                # absorb expects them staged in state[:k0] (that is
                # where the overwrite-mode duplex would place them)
                self.state[:k0] = np.array(
                    self.input_buf, dtype=np.uint64
                )
            k = native.challenger_absorb(self.state, k0, arr)
            if k is not None:
                if k:
                    # last observation left pending input: python would
                    # have cleared the output buffer and not duplexed
                    self.output_buf.clear()
                    self.input_buf = list(self.state[:k])
                else:
                    # last observation completed a block: the duplex
                    # refreshed the output buffer with state[:RATE]
                    self.output_buf = list(self.state[: poseidon.RATE])
                    self.input_buf = []
                return
        for e in arr:
            self.observe_element(e)

    def observe_cap(self, cap: np.ndarray) -> None:
        """A Merkle cap: (2^h, 4) digest matrix."""
        self.observe_elements(np.asarray(cap, dtype=np.uint64).ravel())

    def observe_extension(self, x) -> None:
        """An extension element (c0, c1)."""
        self.observe_elements(np.asarray(x, dtype=np.uint64).ravel())

    # -- challenges ---------------------------------------------------------

    def _duplex(self) -> None:
        k = len(self.input_buf)
        assert k <= poseidon.RATE
        if k:
            self.state[:k] = np.array(self.input_buf, dtype=np.uint64)
            self.input_buf.clear()
        self.state = poseidon.permute(self.state)
        self.output_buf = list(self.state[: poseidon.RATE])

    def get_challenge(self) -> np.uint64:
        if self.input_buf or not self.output_buf:
            self._duplex()
        return np.uint64(self.output_buf.pop())

    def get_n_challenges(self, n: int) -> np.ndarray:
        return np.array([self.get_challenge() for _ in range(n)], dtype=np.uint64)

    def get_extension_challenge(self) -> np.ndarray:
        c0 = self.get_challenge()
        c1 = self.get_challenge()
        return gl.ext(c0, c1)

    def get_indices(self, n: int, domain_bits: int) -> list[int]:
        """n query indices in [0, 2^domain_bits)."""
        mask = (1 << domain_bits) - 1
        return [int(self.get_challenge()) & mask for _ in range(n)]
