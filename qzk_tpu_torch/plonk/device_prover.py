"""Device-resident prove pipeline (torch; CUDA kernels on the card).

Same protocol as the JAX package's ``device_prove``
(qzk_tpu/plonk/device_prover.py), and byte-identical proofs: identical
transcripts, commitments and FRI queries.  One path:
``full_pipeline`` runs the whole post-witness prove as one function of
the uploaded wire matrix, the public-input hash and the three zk salts:
wires commit, the Fiat-Shamir transcript on the device
(DeviceChallenger), zs, quotient, openings, FRI input, FRI layers, the
final polynomial, the first PoW batch, the query indices and every query
gather.  On the card it is one CUDA graph replay a prove (captured once
per context and config); on the CPU the same function runs eagerly.  One
download follows.  ``_fused_prove`` rebuilds the host challenger from
the device's, checks the PoW witness and the query indices against it,
and, when the first batch held no PoW hit, grinds on from the batch's
end on the permutation kernel (grind_pow), re-derives the indices on the
host and gathers the query rounds again.

Merkle hashing runs on the CUDA row sponge (K1) and every permutation
(the PoW batch, the device challenger's duplexes) on the CUDA
permutation (K2), through ops/poseidon_cuda.py; every iNTT and coset LDE
is the four-step transform on the CUDA NTT kernel (K3), through
ops/ntt_fourstep.py; each call of the field arithmetic on int64 bit
patterns is one launch of a field kernel (K4-K7), through
ops/goldilocks_cuda.py, and the rest is torch tensor code (cat, stack,
index).  The stages upload nothing while they run: the constants they
need are the context's, or per-device tables built at first use
(utils/device.py::device_constant).  Under zero knowledge the wires, zs
and quotient leaves carry four salt columns each (the preprocessed tree
none), which the FRI batches skip and the query openings carry.
"""

from __future__ import annotations

import functools
import os
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import goldilocks as gl
from ..ops import goldilocks_cuda as gt
from ..ops import merkle as mk
from ..ops import ntt as ntt_mod
from ..ops import ntt_cuda as nc
from ..ops import ntt_fourstep as nfs
from ..ops import poseidon_cuda as pc
from ..ops.poseidon import RATE, WIDTH
from ..ops.transcript import Challenger
from ..utils import spans
from . import fri as fri_mod
from .proof import (
    FriInitialProof,
    FriProof,
    FriQueryRound,
    FriQueryStep,
    Openings,
    Proof,
    ProofWithPublicInputs,
)
from .vanishing import eval_vanishing_torch


def _gather_tree(leaves, levels, idx):
    """Device (Q,) indices -> (leaves (Q, w), paths (Q, depth, 4)): each
    row and its siblings through the non-cap levels."""
    rows = leaves[idx]
    sibs = [levels[lv][(idx >> lv) ^ 1] for lv in range(len(levels) - 1)]
    if not sibs:
        return rows, torch.zeros((idx.shape[0], 0, 4), dtype=torch.int64, device=idx.device)
    return rows, torch.stack(sibs, dim=1)


@dataclass
class DeviceTree:
    """Merkle tree kept on the device: leaves (n, w), digest levels
    (levels[-1] = cap).  Only the rows a query asks for are
    downloaded."""

    leaves: torch.Tensor
    levels: list
    cap: np.ndarray  # host copy (2^h, 4)

    @classmethod
    def from_levels(cls, leaves, levels) -> "DeviceTree":
        return cls(leaves=leaves, levels=levels, cap=gt.to_u64(levels[-1]))

    def gather_queries(self, idx: np.ndarray):
        """(Q,) host indices -> (leaves (Q, w), paths (Q, depth, 4)) on
        the device."""
        i = torch.as_tensor(np.asarray(idx, dtype=np.int64), device=self.leaves.device)
        return _gather_tree(self.leaves, self.levels, i)


class DeviceChallenger:
    """The host Challenger (ops/transcript.py) on the device: the same
    duplex sponge, observation for observation, so that the whole prove
    needs no host round trip for a challenge.

    The state is a (12,) int64 tensor; the buffers' lengths are Python
    counts, fixed by the circuit's transcript schedule.  The input
    buffer is a list of 1-d tensors of `n_in` elements in all; the
    output buffer is always state[:n_out] (a duplex fills it, an
    observation empties it, a challenge pops its last element).  Every
    duplex is one permutation: K2 at (1, 12) on the card, the plain
    torch permutation on the CPU.  Counterpart of the JAX package's
    DeviceChallenger (qzk_tpu/plonk/device_prover.py:101-171), which
    absorbs element by element; this one absorbs a tensor in chunks of
    up to RATE elements, the same duplex schedule."""

    def __init__(self, device):
        self.state = gt.zeros(WIDTH, device)
        self.input_buf: list = []
        self.n_in = 0
        self.n_out = 0
        self.duplexes = 0

    def fork(self) -> "DeviceChallenger":
        other = DeviceChallenger.__new__(DeviceChallenger)
        other.state = self.state  # never written in place
        other.input_buf = list(self.input_buf)
        other.n_in, other.n_out, other.duplexes = self.n_in, self.n_out, 0
        return other

    def observe_element(self, e) -> None:
        self.observe_elements(e)

    def observe_elements(self, arr) -> None:
        flat = arr.reshape(-1)
        n, pos = flat.shape[0], 0
        while pos < n:
            take = min(RATE - self.n_in, n - pos)
            self.input_buf.append(flat[pos : pos + take])
            self.n_in += take
            self.n_out = 0
            pos += take
            if self.n_in == RATE:
                self._duplex()

    def observe_cap(self, cap) -> None:
        self.observe_elements(cap)

    def pending(self) -> torch.Tensor:
        """The input buffer as one (n_in,) tensor."""
        if len(self.input_buf) == 1:
            return self.input_buf[0]
        if not self.input_buf:
            return self.state.new_zeros(0)
        return torch.cat(self.input_buf)

    def _duplex(self) -> None:
        state = self.state
        if self.n_in:
            state = torch.cat([self.pending(), state[self.n_in :]])
            self.input_buf, self.n_in = [], 0
        self.state = pc.permute(state.reshape(1, WIDTH)).reshape(WIDTH)
        self.n_out = RATE
        self.duplexes += 1

    def get_challenge(self) -> torch.Tensor:
        """A 0-d tensor."""
        if self.n_in or not self.n_out:
            self._duplex()
        self.n_out -= 1
        return self.state[self.n_out]

    def get_n_challenges(self, n: int) -> torch.Tensor:
        return torch.stack([self.get_challenge() for _ in range(n)])

    def get_extension_challenge(self) -> torch.Tensor:
        c0 = self.get_challenge()
        c1 = self.get_challenge()
        return torch.stack([c0, c1])

    def export(self):
        """(state (12,), input buffer (n_in,), output buffer (n_out,)):
        what the host Challenger is rebuilt from."""
        return self.state, self.pending(), self.state[: self.n_out]


def chunk_products(ratios, common) -> list:
    """(n, num_routed) permutation ratios -> the product of each chunk
    of routed wires, [(n,)] a chunk: one launch, the last chunk ragged
    (associativity is exact in the field, so the values equal the
    sequential order's)."""
    t = gt.prod_chunks(ratios, 1, common.chunk_size)
    return [t[:, k] for k in range(common.num_chunks)]


def _ext_reduce(claims, apows):
    """sum_i claims[i] * alpha^i over (S, 2) extension vectors."""
    prod = gt.ext_mul(claims, apows)
    return torch.stack([gt.sum_mod(prod[:, 0], axis=0), gt.sum_mod(prod[:, 1], axis=0)])


# The fused graphs of a card share one memory pool, and their proves a
# lock: a graph's intermediates are dead once its replay has ended, so a
# later capture may reuse them, as long as no two graphs of the card
# run at once.  Without sharing, each graph keeps its own pool of about
# twice the eager prove's peak (22.6 GiB for a (2, 1) chunk circuit on
# the H100), and eight resident contexts came to 68 of the card's 80 GB.
_GRAPH_POOLS: dict = {}
_DEVICE_LOCKS: dict = {}
_CAPTURE_LOCK = threading.Lock()


def _graph_pool(device: torch.device):
    with _CTX_LOCK:
        if device.index not in _GRAPH_POOLS:
            _GRAPH_POOLS[device.index] = torch.cuda.graph_pool_handle()
        return _GRAPH_POOLS[device.index]


def _prove_lock(device: torch.device) -> threading.Lock:
    """The lock a fused prove on `device` holds from its replay through
    the last read of the graph's outputs: one a card, one a CPU
    context."""
    if device.type != "cuda":
        return threading.Lock()
    with _CTX_LOCK:
        return _DEVICE_LOCKS.setdefault(device.index, threading.Lock())


class FusedGraph:
    """The fused pipeline of one context and config as one CUDA graph.

    The first call copies its inputs into static buffers, runs the body
    once eagerly on a side stream (the kernel libraries' first-use
    set-up, such as qzk_poseidon_init's constant upload, cannot be
    captured) and captures it; every call then copies its inputs into
    the static buffers and replays.  The outputs are the capture's
    tensors, overwritten by the next replay: the caller reads them
    under the context's lock.  The kernel launches that the capture
    recorded are counted at each replay (poseidon_cuda.count_replay,
    ntt_cuda.count_replay, goldilocks_cuda.count_replay).  The graph
    lives as long as this object, which the context holds, in the card's shared pool (_graph_pool)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.graph = None
        self.replays = 0
        self.warmup_s = self.capture_s = None
        self.reserved_growth = None  # bytes, torch.cuda.memory_reserved

    def __call__(self, body, wire_matrix, pi_hash, salts):
        if self.graph is None:
            self._capture(body, wire_matrix, pi_hash, salts)
        for static, new in zip(self._inputs, (wire_matrix, pi_hash, *salts)):
            if static is not None:
                static.copy_(new)
        self.graph.replay()
        self.replays += 1
        pc.count_replay(self._k12)
        nc.count_replay(self._k3)
        gt.count_replay(self._field)
        return self._out

    def _capture(self, body, wire_matrix, pi_hash, salts) -> None:
        dev = self.device
        with torch.cuda.device(dev):
            self._inputs = [None if t is None else t.clone()
                            for t in (wire_matrix, pi_hash, *salts)]

            def run():
                wm, pi, *ss = self._inputs
                return body(wm, pi, tuple(ss))

            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            t0 = time.perf_counter()
            with torch.cuda.stream(side):
                run()
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
            self.warmup_s = time.perf_counter() - t0
            # one capture at a time in the process, each on a stream of
            # its own card: torch.cuda.graph's default capture stream is
            # one for the process, made on the card current at its first
            # use, and the aggregator's fan-out captures from one thread a
            # card
            with _CAPTURE_LOCK:
                torch.cuda.empty_cache()
                reserved = torch.cuda.memory_reserved(dev)
                graph = torch.cuda.CUDAGraph()
                t0 = time.perf_counter()
                with pc.recording() as k12, nc.recording() as k3, \
                        gt.recording() as field:
                    with torch.cuda.graph(graph, pool=_graph_pool(dev),
                                          stream=torch.cuda.Stream(dev),
                                          capture_error_mode="thread_local"):
                        out = run()
                torch.cuda.synchronize(dev)
                self.capture_s = time.perf_counter() - t0
                self.reserved_growth = torch.cuda.memory_reserved(dev) - reserved
        self.graph, self._out = graph, out
        self._k12, self._k3, self._field = k12, k3, field


class DeviceProverContext:
    """Per-circuit device constants and pipeline stages.

    Built on the first prove of a circuit on a device and cached on the
    ProverOnlyCircuitData; later proofs reuse the uploaded and derived
    arrays, and the fused pipeline's CUDA graphs."""

    def __init__(self, common, prover_only, device: torch.device):
        self.common = common
        self.device = device
        cfg = common.config
        fri_cfg = cfg.fri_config
        N = common.degree
        lde_size = common.lde_size
        rate_bits = fri_cfg.rate_bits

        def up(a):
            return gt.from_u64(np.ascontiguousarray(a), device)

        # --- uploaded circuit constants: the (S, N) coefficient form and
        # the small per-circuit vectors; the preprocessed LDE and its
        # Merkle tree are derived on the device
        self.pre_coeffs = up(ntt_mod.intt_np(prover_only.preprocessed_values))
        self.sigma_enc = up(prover_only.sigma_encodings.T)  # (N, 80)
        coset_points = gl.mul(
            np.uint64(gl.GENERATOR),
            ntt_mod.powers(ntt_mod.root_of_unity(common.lde_bits), lde_size),
        )
        self.coset_points = up(coset_points)
        z_h = gl.sub(gl.exp(coset_points[: 1 << rate_bits], N), np.uint64(1))
        self.z_h_inv_full = up(np.tile(gl.inverse(z_h), lde_size >> rate_bits))
        self.l1 = up(
            gl.mul(
                np.tile(z_h, lde_size >> rate_bits),
                gl.batch_inverse(
                    gl.mul(np.uint64(N), gl.sub(coset_points, np.uint64(1)))
                ),
            )
        )
        self.shift_inv_pows = up(
            ntt_mod.powers(pow(gl.GENERATOR, gl.P - 2, gl.P), lde_size)
        )
        self.k_is = up(common.k_is)
        g_pows = up(ntt_mod.powers(common.subgroup_generator(), N))
        # four-step NTT plans (K3)
        self.ntt_n = nfs.get_fourstep_cuda_plan(common.degree_bits)
        self.ntt_m = nfs.get_fourstep_cuda_plan(common.lde_bits)
        self.shift_n = up(ntt_mod.powers(gl.GENERATOR, N))
        # transcript constants of the fused pipeline
        self.digest = up(np.asarray(common.circuit_digest, dtype=np.uint64))
        self.g_ext = up(gl.ext(np.uint64(common.subgroup_generator()), np.uint64(0)))

        # --- one-time derivation of the big per-circuit arrays ----------
        self.pre_lde = nfs.coset_lde(self.pre_coeffs, rate_bits, self.shift_n)
        self.pre_tree = self._commit_leaves(self.pre_lde.T)
        if not (self.pre_tree.cap == prover_only.preprocessed_tree.cap).all():
            raise RuntimeError("device-derived preprocessed cap != host cap")
        self.id_enc = gt.mul(g_pows[:, None], self.k_is[None, :])

        # --- wire-matrix assembly as a gather: wm.flat[i] =
        # values_ext[gather[i]], unset slots pointing at an appended zero
        W = cfg.num_wires
        flat = (
            np.asarray(prover_only.slot_rows, dtype=np.int64) * W
            + np.asarray(prover_only.slot_cols, dtype=np.int64)
        )
        self._n_vals = int(prover_only.plan.num_targets)
        self._n_used = len(prover_only.rows)
        gather = np.full(N * W, self._n_vals, dtype=np.int64)
        gather[flat] = np.asarray(prover_only.slot_targets, dtype=np.int64)
        self._wire_gather = torch.as_tensor(gather, device=device)

        # per-(M, arity, shift) FRI layer constants and per-(M, shift)
        # final-polynomial shifts, uploaded at first use
        self._fri_consts: dict = {}
        self._final_consts: dict = {}
        # the fused pipeline: the first PoW batch's candidates (2^18 on
        # the card, as the JAX package's; 2^16 for the plain
        # permutation on the CPU), the CUDA graph per zk flag, and the
        # lock its static outputs are read under
        self.pow_batch = 1 << (18 if device.type == "cuda" else 16)
        self._full_fns: dict = {}
        self.lock = _prove_lock(device)
        self.duplexes: dict = {}  # zk flag -> the challenger's duplexes a prove

    # -- stages ---------------------------------------------------------------

    def assemble_wires(self, values: np.ndarray, blind=None) -> torch.Tensor:
        """Host witness values -> (N, 135) wire matrix on the device;
        rows n_used: take the zk blind block when there is one."""
        values = np.asarray(values, dtype=np.uint64)
        if len(values) != self._n_vals:
            raise ValueError(
                f"witness value count {len(values)} != plan {self._n_vals}"
            )
        v = gt.from_u64(np.concatenate([values, np.zeros(1, np.uint64)]), self.device)
        N, W = self.common.degree, self.common.config.num_wires
        wm = v[self._wire_gather].reshape(N, W)
        if blind is not None:
            wm[self._n_used :] = blind
        return wm

    def commit_leaves_raw(self, lde_t: torch.Tensor, salt=None):
        """(leaves, Merkle levels) over the rows of `lde_t`, with the zk
        salt's four columns appended to each leaf when there is one."""
        leaves = lde_t.contiguous() if salt is None else torch.cat([lde_t, salt], dim=1)
        return leaves, mk.build_merkle_levels(leaves, self.common.config.fri_config.cap_height)

    def _commit_leaves(self, lde_t: torch.Tensor, salt=None) -> DeviceTree:
        return DeviceTree.from_levels(*self.commit_leaves_raw(lde_t, salt))

    def commit_raw(self, values: torch.Tensor, salt=None):
        """(S, N) subgroup values -> coeffs, (S, 8N) coset LDE, leaves
        (salted under zero knowledge) and Merkle levels."""
        coeffs = self.ntt_n.intt(values)
        lde = nfs.coset_lde(coeffs, self.common.config.fri_config.rate_bits, self.shift_n)
        return (coeffs, lde, *self.commit_leaves_raw(lde.T, salt))

    def zs_stage(self, w_routed, betas, gammas):
        """(N, 80) routed wires -> (num_zs_pp, N) Z / partial-product
        columns.  Chunk products reduce as a halving tree: associativity
        is exact in the field, so the values equal the sequential
        order's."""
        common = self.common
        cfg = common.config
        rows = []
        for c in range(cfg.num_challenges):
            beta, gamma = betas[c], gammas[c]
            nums = gt.add(gt.add(w_routed, gt.mul(beta, self.id_enc)), gamma)
            dens = gt.add(gt.add(w_routed, gt.mul(beta, self.sigma_enc)), gamma)
            ratios = gt.batch_divide_axis(nums, dens, axis=1)
            chunk_prods = chunk_products(ratios, common)
            row_ratio = chunk_prods[0]
            for k in range(1, common.num_chunks):
                row_ratio = gt.mul(row_ratio, chunk_prods[k])
            z = gt.prefix_prod_exclusive(row_ratio)
            rows.append(z)
            cum = z
            for k in range(common.num_partial_products):
                cum = gt.mul(cum, chunk_prods[k])
                rows.append(cum)
        return torch.stack(rows)

    def quotient_stage(self, wires_lde, zs_lde, pi_hash, betas, gammas, alphas):
        """-> quotient coeffs, quotient LDE, and tail_ok: a device bool,
        true when the quotient's degree is within the bound (a witness
        that satisfies the circuit)."""
        common = self.common
        cfg = common.config
        N = common.degree
        n_pp = common.num_partial_products
        n_sel, n_const = common.num_selectors, cfg.num_constants
        rate = 1 << cfg.fri_config.rate_bits
        zs_at, zs_right, partials_at = [], [], []
        for c in range(cfg.num_challenges):
            base = c * (1 + n_pp)
            zs_at.append(zs_lde[base])
            zs_right.append(torch.roll(zs_lde[base], -rate))
            partials_at.append([zs_lde[base + 1 + k] for k in range(n_pp)])
        pre = self.pre_lde
        vanishing = eval_vanishing_torch(
            common, self.coset_points, wires_lde,
            pre[:n_sel], pre[n_sel : n_sel + n_const], pre[n_sel + n_const :],
            zs_at, zs_right, partials_at, pi_hash, betas, gammas, alphas,
            self.l1, self.k_is,
        )
        deg_cap = cfg.max_quotient_degree_factor * N
        qv = gt.mul(torch.stack(vanishing), self.z_h_inv_full)
        q_coeffs = gt.mul(self.ntt_m.intt(qv), self.shift_inv_pows)
        tail_ok = (q_coeffs[:, deg_cap - N :] == 0).all()
        quotient_coeffs = q_coeffs[:, :deg_cap].reshape(-1, N)
        quotient_lde = nfs.coset_lde(quotient_coeffs, cfg.fri_config.rate_bits, self.shift_n)
        return quotient_coeffs, quotient_lde, tail_ok

    def openings_stage(self, wires_coeffs, zs_coeffs, quotient_coeffs, zeta, zeta_right):
        N = self.common.degree
        pows, pows_r = gt.ext_powers_multi((zeta, zeta_right), N)

        def eval_polys_ext(coeffs, p):
            c0 = gt.dot_mod(coeffs, p[None, :, 0], axis=1)
            c1 = gt.dot_mod(coeffs, p[None, :, 1], axis=1)
            return torch.stack([c0, c1], dim=-1)

        return (
            eval_polys_ext(self.pre_coeffs, pows),
            eval_polys_ext(wires_coeffs, pows),
            eval_polys_ext(zs_coeffs, pows),
            eval_polys_ext(quotient_coeffs, pows),
            eval_polys_ext(zs_coeffs, pows_r),
        )

    def _fri_input_one(self, lde_rows, apows, reduced_claim, z):
        """alpha-combined (F(x) - F(z)) / (x - z) over the coset."""
        comb0 = gt.dot_mod(lde_rows, apows[:, 0:1], axis=0)
        comb1 = gt.dot_mod(lde_rows, apows[:, 1:2], axis=0)
        comb = torch.stack([comb0, comb1], dim=-1)
        num = gt.ext_sub(comb, reduced_claim.expand(comb.shape))
        den = torch.stack(
            [
                gt.sub(self.coset_points, z[0]),
                gt.neg(z[1]).expand(self.common.lde_size),
            ],
            dim=-1,
        )
        return gt.ext_mul(num, gt.ext_inverse_vec(den))

    def fri_input_stage(self, wires_lde, zs_lde, quotient_lde, apows_all,
                        claim_all, zeta, apows_zs, claim_zs, zeta_right):
        all_lde = torch.cat([self.pre_lde, wires_lde, zs_lde, quotient_lde])
        G = self._fri_input_one(all_lde, apows_all, claim_all, zeta)
        G2 = self._fri_input_one(zs_lde, apows_zs, claim_zs, zeta_right)
        return gt.ext_add(G, G2)

    def fri_layer(self, M: int, arity_bits: int, shift: int, cap_h: int):
        """(commit_layer, fold_layer, group) for one FRI layer shape:
        commit_layer(values) -> (leaves, Merkle levels)."""
        A = 1 << arity_bits
        key = (M, arity_bits, shift)
        if key not in self._fri_consts:
            w_M = ntt_mod.root_of_unity(M.bit_length() - 1)
            self._fri_consts[key] = (
                gt.from_u64(fri_mod._fold_matrices(arity_bits), self.device),  # (A, A)
                gt.from_u64(
                    gl.mul(
                        np.uint64(pow(shift, gl.P - 2, gl.P)),
                        ntt_mod.powers(pow(w_M, gl.P - 2, gl.P), M // A),
                    ),
                    self.device,
                ),
            )
        W, s_j_inv = self._fri_consts[key]

        def group(values):
            # (M, 2) -> (M/A, A, 2): points sharing x^A (stride M/A)
            return values.reshape(A, M // A, 2).movedim(0, 1)

        def commit_layer(values):
            leaves = group(values).reshape(M // A, 2 * A).contiguous()
            return leaves, mk.build_merkle_levels(leaves, cap_h)

        def fold_layer(values, beta):
            groups = group(values)  # (M/A, A, 2)
            c = gt.zeros((M // A, A, 2), self.device)
            for k in range(A):
                c = gt.add(c, gt.mul(groups[:, k, None, :], W[k][None, :, None]))
            t_pows = []
            acc = gt.ones(M // A, self.device)
            for _ in range(A):
                t_pows.append(acc)
                acc = gt.mul(acc, s_j_inv)
            c = gt.mul(c, torch.stack(t_pows, dim=1)[..., None])
            out = gt.zeros((M // A, 2), self.device)
            beta_b = beta.expand(M // A, 2)
            for t in reversed(range(A)):
                out = gt.ext_add(gt.ext_mul(out, beta_b), c[:, t])
            return out

        return commit_layer, fold_layer, group

    def final_poly(self, values: torch.Tensor, shift: int):
        """The last FRI layer's (M, 2) values on the coset of `shift` ->
        (final polynomial (final_len, 2), final_ok): the coset iNTT on
        the device (plain torch, as the JAX package's runs in XLA);
        final_ok is a device bool, true when the coefficients past
        final_len are zero."""
        M = values.shape[0]
        key = (M, shift)
        if key not in self._final_consts:
            self._final_consts[key] = gt.from_u64(
                ntt_mod.powers(pow(shift, gl.P - 2, gl.P), M), self.device)
        coeffs = gt.mul(ntt_mod.get_plan(M.bit_length() - 1).intt(values.T),
                        self._final_consts[key])  # (2, M)
        common = self.common
        arities = common.config.fri_config.reduction_arity_bits(common.degree_bits)
        final_len = 1 << max(0, common.degree_bits - sum(arities))
        return coeffs[:, :final_len].T, (coeffs[:, final_len:] == 0).all()

    def grind_pow(self, challenger: Challenger, bits: int, start: int = 0) -> int:
        """Batched PoW grind on the permutation kernel (K2): the first
        candidate from `start` on whose challenge has `bits` leading
        zeros, identical to fri.grind_pow when no candidate below
        `start` has.  Batches of 2^18 candidates on the card (2^12 for
        the plain version on the CPU)."""
        B = 1 << (18 if self.device.type == "cuda" else 12)
        pending = list(challenger.input_buf)
        n_pending = len(pending)
        base = np.array(challenger.state, dtype=np.uint64)
        base[:n_pending] = np.array(pending, dtype=np.uint64)
        states0 = gt.from_u64(base, self.device).expand(B, 12).clone()
        lane = torch.arange(B, dtype=torch.int64, device=self.device)
        while True:
            states = states0.clone()
            states[:, n_pending] = lane + start
            out = pc.permute(states)
            ok = gt.shr(out[:, 7], 64 - bits) == 0
            hits = torch.nonzero(ok)
            if hits.numel():
                found = start + int(hits[0, 0])
                break
            start += B
        challenger.observe_element(found)
        check = int(challenger.get_challenge())
        if check >> (64 - bits) != 0:
            raise RuntimeError("PoW self-check failed")
        return found

    # -- the fused pipeline ------------------------------------------------------

    def full_pipeline(self, salted: bool):
        """The whole post-witness prove as one function (counterpart of
        the JAX package's full_pipeline): (wire matrix (N, 135), pi_hash
        (4,), salts) -> (outputs, layout), where salts are the wires',
        zs' and quotient's (lde, 4) salts (None each without zero
        knowledge).  `outputs` holds the trees and FRI layers on the
        device and `packed`, every small output in one int64 vector,
        whose fields `layout` lists; see _pipeline.  On the card it
        replays the context's CUDA graph (FusedGraph); on the CPU it
        runs eagerly."""

        def body(wire_matrix, pi_hash, salts):
            return self._pipeline(salted, wire_matrix, pi_hash, salts)

        if self.device.type != "cuda":
            return body
        graph = self._full_fns.get(salted)
        if graph is None:
            graph = self._full_fns[salted] = FusedGraph(self.device)
        return functools.partial(graph, body)

    def _pipeline(self, salted: bool, wire_matrix, pi_hash, salts):
        """full_pipeline's body (the JAX package's pipeline,
        qzk_tpu/plonk/device_prover.py:657-819, step for step).  Every
        value that depends on the witness or the transcript stays a
        device tensor: nothing here synchronizes with the host or
        uploads, so that the body can be captured."""
        common = self.common
        cfg = common.config
        fri_cfg = cfg.fri_config
        ch = DeviceChallenger(self.device)
        # 2. commit wires
        w_coeffs, w_lde, w_leaves, w_levels = self.commit_raw(
            wire_matrix.T, salts[0] if salted else None)
        ch.observe_elements(self.digest)
        ch.observe_elements(pi_hash)
        ch.observe_cap(w_levels[-1])
        betas = ch.get_n_challenges(cfg.num_challenges)
        gammas = ch.get_n_challenges(cfg.num_challenges)
        # 3. permutation argument
        zs_pp = self.zs_stage(wire_matrix[:, : cfg.num_routed_wires], betas, gammas)
        z_coeffs, z_lde, z_leaves, z_levels = self.commit_raw(
            zs_pp, salts[1] if salted else None)
        ch.observe_cap(z_levels[-1])
        alphas = ch.get_n_challenges(cfg.num_challenges)
        # 4. quotient
        q_coeffs, q_lde, tail_ok = self.quotient_stage(
            w_lde, z_lde, pi_hash, betas, gammas, alphas)
        q_leaves, q_levels = self.commit_leaves_raw(q_lde.T, salts[2] if salted else None)
        ch.observe_cap(q_levels[-1])
        zeta = ch.get_extension_challenge()
        zeta_right = gt.ext_mul(zeta, self.g_ext)
        # 5. openings
        opened = self.openings_stage(w_coeffs, z_coeffs, q_coeffs, zeta, zeta_right)
        zeta_claims = torch.cat(opened[:4])
        ch.observe_elements(zeta_claims)
        ch.observe_elements(opened[4])
        fri_alpha = ch.get_extension_challenge()
        apows_all = gt.ext_powers(fri_alpha, zeta_claims.shape[0])
        apows_zs = apows_all[: opened[4].shape[0]]  # the same powers, fewer
        G = self.fri_input_stage(
            w_lde, z_lde, q_lde, apows_all, _ext_reduce(zeta_claims, apows_all), zeta,
            apows_zs, _ext_reduce(opened[4], apows_zs), zeta_right)
        # FRI commit phase
        arities = fri_cfg.reduction_arity_bits(common.degree_bits)
        shift = gl.GENERATOR
        values = G
        layers = []
        for ab in arities:
            M = values.shape[0]
            cap_h = fri_mod._layer_cap_height(fri_cfg, M >> ab)
            commit_layer, fold_layer, group = self.fri_layer(M, ab, shift, cap_h)
            leaves, levels = commit_layer(values)
            ch.observe_cap(levels[-1])
            beta = ch.get_extension_challenge()
            layers.append((leaves, levels, values, group))
            values = fold_layer(values, beta)
            shift = pow(shift, 1 << ab, gl.P)
        final_poly, final_ok = self.final_poly(values, shift)
        ch.observe_elements(final_poly)

        # the first PoW batch (the host grinds on when it holds no hit)
        B = self.pow_batch
        lane = torch.arange(B, dtype=torch.int64, device=self.device)
        states = ch.state.expand(B, WIDTH).clone()
        if ch.n_in:
            states[:, : ch.n_in] = ch.pending()
        states[:, ch.n_in] = lane
        pow_out = pc.permute(states)
        ok = gt.shr(pow_out[:, 7], 64 - fri_cfg.proof_of_work_bits) == 0
        pow_cand = torch.where(ok, lane, B).min()  # B: no hit

        # query indices from a fork that observes the candidate as the
        # host transcript does, and every query gather
        ch2 = ch.fork()
        ch2.observe_element(pow_cand)
        ch2.get_challenge()  # the PoW self-check draw
        mask = (1 << common.lde_bits) - 1
        qidx = torch.stack(
            [ch2.get_challenge() & mask for _ in range(fri_cfg.num_query_rounds)])
        self.duplexes[salted] = ch.duplexes + ch2.duplexes

        trees = {"pre": (self.pre_tree.leaves, self.pre_tree.levels),
                 "wires": (w_leaves, w_levels), "zs": (z_leaves, z_levels),
                 "quotient": (q_leaves, q_levels)}
        state, inb, outb = ch.export()
        small = {"tail_ok": tail_ok, "final_ok": final_ok, "final_poly": final_poly,
                 "ch_state": state, "ch_in": inb, "ch_out": outb,
                 "pow_hit": pow_cand < B, "pow_cand": pow_cand, "qidx": qidx}
        for i, o in enumerate(opened):
            small[f"opened{i}"] = o
        for name, (leaves, levels) in trees.items():
            if name != "pre":
                small[f"cap_{name}"] = levels[-1]
            small[f"rows_{name}"], small[f"paths_{name}"] = _gather_tree(leaves, levels, qidx)
        j = qidx
        for t, (leaves, levels, vals, group) in enumerate(layers):
            small[f"cap_layer{t}"] = levels[-1]
            jg = j % (vals.shape[0] >> arities[t])
            small[f"step{t}_leaf"] = group(vals)[jg]
            small[f"step{t}_path"] = _gather_tree(leaves, levels, jg)[1]
            j = jg
        layout = [(name, tuple(t.shape)) for name, t in small.items()]
        packed = torch.cat([t.reshape(-1).to(torch.int64) for t in small.values()])
        out = {"trees": trees, "layers": layers, "packed": packed}
        return out, layout


def _unpack(flat: np.ndarray, layout) -> dict:
    """The packed small outputs, by name, as uint64 arrays."""
    out, pos = {}, 0
    for name, shape in layout:
        n = int(np.prod(shape, dtype=np.int64))
        out[name] = flat[pos : pos + n].reshape(shape)
        pos += n
    return out


# LRU over live device contexts: each context pins its circuit's
# preprocessed LDE, tree and derived arrays in device memory, and on the
# card its fused pipeline's CUDA graphs and their memory pools; an
# aggregation tree proves one more circuit a level.
# Keeping at most QZK_CTX_LIMIT contexts resident turns that into
# eviction and a rebuild.  Entries: (id(ctxs), key, ctxs, common) in
# least-recent-first order; ctxs is the owning prover_only's
# _torch_ctxs.
_CTX_LRU: list = []
_CTX_LOCK = threading.Lock()


def _ctx_limit() -> int:
    try:
        return max(1, int(os.environ.get("QZK_CTX_LIMIT", "3")))
    except ValueError:
        return 3


def _lru_touch(ctxs, key, common) -> None:
    entry = (id(ctxs), key)
    for i, (eid, ekey, _, _) in enumerate(_CTX_LRU):
        if (eid, ekey) == entry:
            _CTX_LRU.append(_CTX_LRU.pop(i))
            return
    _CTX_LRU.append((id(ctxs), key, ctxs, common))


def _evict_down_to(n_keep: int) -> int:
    """Drop the least recent contexts down to `n_keep`; returns how many."""
    n = 0
    while len(_CTX_LRU) > n_keep:
        _, key, ctxs, _ = _CTX_LRU.pop(0)
        ctxs.pop(key, None)  # drop the refs; torch frees the memory and the graphs
        n += 1
    return n


def context_device(device) -> torch.device:
    """`device` with its index: a bare "cuda" is the current card, so
    that "cuda" and "cuda:0" share one context."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _build_context(common, prover_only, dev: torch.device) -> DeviceProverContext:
    """A new context on `dev`, after evicting down to the limit (to none,
    and built again, if the build runs out of device memory); sets the
    open span's `evicted` and, on a card, `bytes`."""
    measure = dev.type == "cuda" and spans.in_request()

    def allocated() -> int:
        return torch.cuda.memory_allocated(dev) if measure else 0

    with _CTX_LOCK:
        evicted = _evict_down_to(_ctx_limit() - 1)
    before = allocated()
    ctx = None
    try:
        ctx = DeviceProverContext(common, prover_only, dev)
    except torch.cuda.OutOfMemoryError:
        pass  # retried below, once the handler has let go of the failed build
    if ctx is None:
        with _CTX_LOCK:
            evicted += _evict_down_to(0)
        before = allocated()
        ctx = DeviceProverContext(common, prover_only, dev)
    spans.set_attrs(evicted=evicted)
    if measure:
        spans.set_attrs(bytes=allocated() - before)
    return ctx


def get_context(common, prover_only, device) -> DeviceProverContext:
    """The circuit's context on `device`, built at first use.

    Contexts are keyed by the device with its index, so that concurrent
    chunk proves on several cards (the aggregator's fan-out) each get
    arrays on their own card.  A process-wide LRU bounds the resident
    contexts (see _CTX_LRU above); when building one runs out of device
    memory, every other context is evicted and the build retried once on
    the same device.  A build is the span "device.context": `degree_bits`,
    `evicted` (the contexts dropped to make room) and, on a card, `bytes`
    (the device memory the build added there)."""
    dev = context_device(device)
    key = str(dev)
    ctxs = getattr(prover_only, "_torch_ctxs", None)
    if ctxs is None:
        ctxs = prover_only._torch_ctxs = {}
    ctx = ctxs.get(key)
    if ctx is None:
        with spans.span("device.context", attrs={"degree_bits": common.degree_bits}):
            ctx = ctxs[key] = _build_context(common, prover_only, dev)
    with _CTX_LOCK:
        _lru_touch(ctxs, key, common)
    return ctx


def _assemble_query_rounds(groups, arities, oracles, layer_values, layer_trees, indices):
    """Device gathers for all oracles and FRI layers, then one download;
    returns the per-round proof structures."""
    idx = np.array(indices, dtype=np.int64)
    oracle_data = [tuple(gt.to_u64(a) for a in t.gather_queries(idx)) for t in oracles]
    step_data = []
    j = idx
    for t, ab in enumerate(arities):
        A = 1 << ab
        M = layer_values[t].shape[0]
        jg = j % (M // A)
        grouped = groups[t](layer_values[t])[torch.as_tensor(jg, device=layer_values[t].device)]
        step_data.append((gt.to_u64(grouped), gt.to_u64(layer_trees[t].gather_queries(jg)[1])))
        j = jg
    return _rounds_from_data(oracle_data, step_data, len(indices))


def _rounds_from_data(oracle_data, step_data, Q):
    """Host proof structures from downloaded query-gather arrays:
    oracle_data = [(rows (Q, w), paths (Q, depth, 4))] per oracle,
    step_data = [(grouped (Q, A, 2), paths (Q, depth, 4))] per layer."""
    rounds = []
    for q in range(Q):
        leaves_q = [np.asarray(rows[q], dtype=np.uint64) for rows, _ in oracle_data]
        paths_q = [
            [np.asarray(paths[q, d], dtype=np.uint64) for d in range(paths.shape[1])]
            for _, paths in oracle_data
        ]
        steps = [
            FriQueryStep(
                leaf=np.asarray(leaf_rows[q], dtype=np.uint64),
                path=[np.asarray(paths[q, d], dtype=np.uint64) for d in range(paths.shape[1])],
            )
            for leaf_rows, paths in step_data
        ]
        rounds.append(
            FriQueryRound(
                initial=FriInitialProof(leaves=leaves_q, paths=paths_q),
                steps=steps,
            )
        )
    return rounds


def _fused_prove(ctx, values, blind_block, public_inputs, pi_hash, fresh_salt,
                 mark) -> ProofWithPublicInputs:
    """device_prove through full_pipeline (counterpart of the JAX
    package's _fused_prove): one graph replay covers the wires commit
    through the query gathers; one download brings every small output;
    the host challenger is rebuilt from the device's for the PoW
    self-check and the query indices."""
    common = ctx.common
    cfg = common.config
    fri_cfg = cfg.fri_config
    arities = fri_cfg.reduction_arity_bits(common.degree_bits)
    salted = cfg.zero_knowledge
    # drawn in the blinding stream's order: wires, zs, quotient
    salts = tuple(fresh_salt(common.lde_size) for _ in range(3))
    with spans.span("fused.upload"):
        wire_matrix = ctx.assemble_wires(values, blind_block)
        pi_dev = gt.from_u64(np.asarray(pi_hash, dtype=np.uint64), ctx.device)
    # the graph's outputs are overwritten by its next replay
    with spans.locked(ctx.lock, "fused.lock_wait", "fused.lock_held"):
        with spans.span("fused.replay", device=ctx.device):
            out, layout = ctx.full_pipeline(salted)(wire_matrix, pi_dev, salts)
        with spans.span("fused.download"):
            small = _unpack(gt.to_u64(out["packed"]), layout)
        if not small["tail_ok"]:
            raise ValueError(
                "constraints unsatisfied: quotient degree overflow "
                "(witness does not satisfy the circuit)"
            )
        if not small["final_ok"]:
            raise RuntimeError("FRI final poly degree too high")
        openings = Openings(preprocessed=small["opened0"], wires=small["opened1"],
                            zs_partial=small["opened2"], quotient=small["opened3"],
                            zs_partial_right=small["opened4"])
        mark("fused pipeline (device, 1 dispatch)")

        # the host challenger at the point after the final polynomial
        challenger = Challenger()
        challenger.state = small["ch_state"].copy()
        challenger.input_buf = [np.uint64(x) for x in small["ch_in"]]
        challenger.output_buf = [np.uint64(x) for x in small["ch_out"]]
        bits = fri_cfg.proof_of_work_bits
        nq = fri_cfg.num_query_rounds
        if small["pow_hit"]:
            pow_witness = int(small["pow_cand"])
            challenger.observe_element(pow_witness)
            if int(challenger.get_challenge()) >> (64 - bits) != 0:
                raise RuntimeError("PoW self-check failed")
            indices = challenger.get_indices(nq, common.lde_bits)
            if [int(v) for v in small["qidx"]] != indices:
                raise RuntimeError("device query indices != host transcript replay")
            mark("PoW finalize (host)")
            oracle_data = [(small[f"rows_{n}"], small[f"paths_{n}"])
                           for n in ("pre", "wires", "zs", "quotient")]
            step_data = [(small[f"step{t}_leaf"], small[f"step{t}_path"])
                         for t in range(len(arities))]
            rounds = _rounds_from_data(oracle_data, step_data, nq)
        else:  # no hit in the batch: grind on, re-derive and re-gather
            with spans.span("pow.grind"):
                pow_witness = ctx.grind_pow(challenger, bits, start=ctx.pow_batch)
                mark("PoW finalize (host)")
                indices = challenger.get_indices(nq, common.lde_bits)
                oracles = [ctx.pre_tree] + [
                    DeviceTree(*out["trees"][n], cap=small[f"cap_{n}"])
                    for n in ("wires", "zs", "quotient")]
                layer_trees = [DeviceTree(leaves, levels, cap=small[f"cap_layer{t}"])
                               for t, (leaves, levels, _, _) in enumerate(out["layers"])]
                rounds = _assemble_query_rounds(
                    [group for *_, group in out["layers"]], arities, oracles,
                    [vals for _, _, vals, _ in out["layers"]], layer_trees, indices)
        mark("FRI queries (in-dispatch gathers)")

    proof = Proof(
        wires_cap=small["cap_wires"],
        zs_partial_cap=small["cap_zs"],
        quotient_cap=small["cap_quotient"],
        openings=openings,
        fri=FriProof(
            commit_phase_caps=[small[f"cap_layer{t}"] for t in range(len(arities))],
            final_poly=small["final_poly"],
            pow_witness=pow_witness,
            query_rounds=rounds,
        ),
    )
    return ProofWithPublicInputs(proof=proof, public_inputs=public_inputs)


def device_prove(common, prover_only, values, blind_block, public_inputs, pi_hash,
                 fresh_salt, device: torch.device, timer=None) -> ProofWithPublicInputs:
    """Steps 2-5 of the prove pipeline on `device`, from the host
    witness values.  Called by plonk.prover.prove, which passes the zk
    blind block (or None) and fresh_salt(n_leaves), the next (n, 4)
    salt of the blinding stream (None without zero knowledge): drawn
    for the wires, the zs and the quotient, in that order."""
    mark = timer.mark if timer is not None else (lambda name: None)
    ctx = get_context(common, prover_only, device)
    return _fused_prove(ctx, values, blind_block, public_inputs, pi_hash,
                        fresh_salt, mark)
