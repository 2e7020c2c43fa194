"""The sharded PLONK prove pipeline over a mesh of shard devices.

Counterpart of the JAX package's qzk_tpu/parallel/prover_sharded.py,
stage for stage, and byte-identical with the single-device pipeline
(plonk/device_prover.py): identical transcripts, commitments and proof
bytes.  One process drives every shard (parallel/sharded.py):

  commit    polynomial rows are data-parallel for the iNTT and coset LDE
            (K3); ONE all_to_all re-shards rows -> LDE points; leaf
            hashing and every Merkle level down to the local cap are
            then local (K1; the cap has >= d entries, so block sharding
            keeps every level's parent local); one all_gather replicates
            the cap.
  Zs        the permutation argument rows are point-parallel over N; the
            running-product column Z needs a global prefix product: a
            local Hillis-Steele prefix, an all_gather of the d shard
            totals and a local offset multiply (the distributed scan).
  quotient  constraint evaluation is pointwise over the LDE coset
            (sharded); zs_right's rotation pulls a `rate`-row halo from
            the next shard (ppermute); the degree-M iNTT back to the
            quotient coefficients runs as the distributed four-step NTT
            (parallel/ntt_sharded.py, three all_to_alls, K3 locally).
  openings  polynomial rows are data-parallel; each shard evaluates its
            rows at zeta / g*zeta.
  FRI       the input polynomial is pointwise over the coset (sharded);
            each fold layer regroups stride-M/A cosets with ONE
            all_to_all (arity 16 >= the mesh size, so each shard ends
            with whole groups), folds locally and commits locally; the
            small tail layers, the final polynomial, the PoW grind (K2)
            and the query gathers run on shard 0's device, through its
            single-device prover context.

The stages are staged, not fused: Fiat-Shamir runs on the host between
them, as in the JAX package's sharded path.
Between stages, XLA's implicit re-shardings of the JAX package become
explicit exchanges: the Zs columns go from point to row sharding by an
all_to_all, the quotient rows from factor to row sharding by
ShardedProverContext.factor_rows_to_row_blocks.

Mesh sizes: a power of two, <= 2^cap_height (16) for the commit layout
and dividing max_quotient_degree_factor (8) for the quotient re-shard;
the standard config supports d in {2, 4, 8}.  `qzk_tpu_torch.parallel.
set_mesh(mesh)` routes every later `prove` through this pipeline.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import goldilocks as gl
from ..ops import goldilocks_cuda as gt
from ..ops import merkle as mk
from ..ops import ntt as ntt_mod
from ..ops.transcript import Challenger
from ..plonk import fri as fri_mod
from ..plonk.device_prover import (
    DeviceTree,
    _assemble_query_rounds,
    chunk_products,
    get_context,
)
from ..plonk.proof import FriProof, Openings, Proof, ProofWithPublicInputs
from ..plonk.vanishing import eval_vanishing_torch
from . import kernels, ntt_sharded
from .sharded import (
    Mesh,
    all_gather,
    all_to_all,
    concat_on,
    gather,
    ppermute,
    psum,
    replicate,
    shard,
)

# Sharded proves completed in this process.
PROVES = {"sharded_prove": 0}


def _pad_rows(a: torch.Tensor, d: int) -> torch.Tensor:
    """Zero-pad axis 0 to a multiple of d (zero polys commit to zeros
    and open to zero; trimmed before anything observes them)."""
    pad = (-a.shape[0]) % d
    if pad == 0:
        return a
    return torch.cat([a, a.new_zeros((pad, *a.shape[1:]))])


def mesh_preconditions_ok(common, mesh: Mesh) -> bool:
    """True iff this (circuit, mesh) pair satisfies every divisibility
    constraint the sharded pipeline assumes.  plonk.prover falls back to
    the single-device pipeline when this is False."""
    cfg = common.config
    fri_cfg = cfg.fri_config
    d = mesh.size
    N = common.degree
    M = common.lde_size
    return (
        d >= 1
        and (d & (d - 1)) == 0  # power of two
        and d <= 1 << fri_cfg.cap_height  # divides the Merkle cap width
        and cfg.max_quotient_degree_factor % d == 0
        and N % d == 0
        and N >= d
        # the sharded quotient stage reshapes per-shard M/d coefficient
        # chunks into (nc, factor/d, N): requires rate == quotient factor
        and M == cfg.max_quotient_degree_factor * N
        # the zs ppermute halo needs a full blowup block per shard
        and M // d >= 1 << fri_cfg.rate_bits
    )


class ShardedProverContext:
    """Per-(circuit, mesh) point-sharded constants and the stages.

    The constants are split from the circuit's single-device context on
    shard 0 (plonk/device_prover.py::get_context), which derives them on
    the device; each shard keeps its own copy."""

    def __init__(self, common, prover_only, mesh: Mesh):
        self.common = common
        self.mesh = mesh
        cfg = common.config
        fri_cfg = cfg.fri_config
        d = mesh.size
        if not mesh_preconditions_ok(common, mesh):
            raise ValueError(
                f"a {d}-shard mesh does not meet the sharded prover's preconditions for a "
                f"circuit of degree {common.degree}, LDE size {common.lde_size}, quotient "
                f"factor {cfg.max_quotient_degree_factor} and cap height "
                f"{fri_cfg.cap_height}; use the single-device pipeline"
            )
        self.d = d
        self.log_d = d.bit_length() - 1
        self.rate_bits = fri_cfg.rate_bits
        self.cap_height = fri_cfg.cap_height
        base = get_context(common, prover_only, mesh.devices[0])

        # point-sharded circuit constants (leaf-row layout (M, S))
        self.pre_t = shard(base.pre_lde.T, mesh)
        self.pre_coeffs = shard(_pad_rows(base.pre_coeffs, d), mesh)
        self.n_pre = base.pre_coeffs.shape[0]
        self.id_enc = shard(base.id_enc, mesh)
        self.sigma_enc = shard(base.sigma_enc, mesh)
        self.coset_points = shard(base.coset_points, mesh)
        self.z_h_inv = shard(base.z_h_inv_full, mesh)
        self.l1 = shard(base.l1, mesh)
        self.shift_inv_pows = shard(base.shift_inv_pows, mesh)
        self.intt_tw = shard(ntt_sharded._twiddle_table(common.lde_bits, d, True), mesh)
        self.k_is = replicate(base.k_is, mesh)
        self._stage_cache: dict = {}

    # -- stage: transform + commit -------------------------------------------

    def commit(self, value_blocks, true_s: int, salt_blocks, from_coeffs: bool):
        """Row-sharded (S'/d, N) blocks -> (coeffs blocks (S'/d, N),
        leaves blocks (M/d, true_s[+4]) point-sharded, their Merkle
        levels down to the local cap, the cap (2^h, 4) on the host).
        S' must be a multiple of the mesh size."""
        mesh = self.mesh
        local_cap_h = self.cap_height - self.log_d
        coeffs, lde = [], []
        for v in value_blocks:
            if from_coeffs:
                c, e = v, kernels.coset_lde_rows(v, self.rate_bits)
            else:
                c, e = kernels.intt_lde_rows(v, self.rate_bits)
            coeffs.append(c)
            lde.append(e)
        lde_t = all_to_all(lde, mesh, split_axis=1, concat_axis=0)  # (S', M/d)
        del lde
        leaves, levels = [], []
        for i, lt in enumerate(lde_t):
            rows = lt[:true_s].T  # (M/d, true_s)
            leaf = (rows.contiguous() if salt_blocks is None
                    else torch.cat([rows, salt_blocks[i]], dim=1))
            leaves.append(leaf)
            levels.append(mk.build_merkle_levels(leaf, local_cap_h))
        cap = all_gather([lv[-1] for lv in levels], mesh)
        return coeffs, leaves, levels, gt.to_u64(cap[0])

    # -- stage: permutation Z / partial products ------------------------------

    def zs_stage(self, w_routed, betas, gammas) -> list:
        """w_routed (N/d, 80) blocks, point-sharded over N -> the Z and
        partial-product rows (num_zs, N/d), sharded over N."""
        common = self.common
        cfg = common.config
        mesh = self.mesh
        d = self.d
        n_pp = common.num_partial_products
        betas_b, gammas_b = replicate(betas, mesh), replicate(gammas, mesh)
        local = []  # per shard, per challenge: (chunk products, exclusive prefix, total)
        for i in range(d):
            per_c = []
            for c in range(cfg.num_challenges):
                beta, gamma = betas_b[i][c], gammas_b[i][c]
                nums = gt.add(gt.add(w_routed[i], gt.mul(beta, self.id_enc[i])), gamma)
                dens = gt.add(gt.add(w_routed[i], gt.mul(beta, self.sigma_enc[i])), gamma)
                ratios = gt.batch_divide_axis(nums, dens, axis=1)
                chunk_prods = chunk_products(ratios, common)
                row_ratio = chunk_prods[0]
                for k in range(1, common.num_chunks):
                    row_ratio = gt.mul(row_ratio, chunk_prods[k])
                # local exclusive scan, and the shard's product
                excl = gt.prefix_prod_exclusive(row_ratio)
                per_c.append((chunk_prods, excl, gt.mul(excl[-1:], row_ratio[-1:])))
            local.append(per_c)
        rows = [[] for _ in range(d)]
        for c in range(cfg.num_challenges):
            # distributed exclusive prefix product over N: the shards'
            # totals, then each shard's offset from those before it
            totals = all_gather([local[i][c][2] for i in range(d)], mesh)  # (d,)
            for my in range(d):
                chunk_prods, excl, _ = local[my][c]
                idx = torch.arange(d, device=excl.device)
                masked = torch.where(idx < my, totals[my], torch.ones_like(totals[my]))
                offset = masked[0]
                for i in range(1, d):
                    offset = gt.mul(offset, masked[i])
                z = gt.mul(offset, excl)
                rows[my].append(z)
                cum = z
                for k in range(n_pp):
                    cum = gt.mul(cum, chunk_prods[k])
                    rows[my].append(cum)
        return [torch.stack(r) for r in rows]

    # -- stage: quotient coefficients ------------------------------------------

    def quotient_stage(self, wires_t, zs_t, pi_hash, betas, gammas, alphas):
        """Point-sharded leaf rows -> the quotient coefficient rows
        (num_challenges, factor/d, N) a shard, sharded over the factor
        axis, and the psum'd count of nonzero coefficients in the last
        degree-N block (an int; nonzero: the witness does not satisfy
        the circuit)."""
        common = self.common
        cfg = common.config
        mesh = self.mesh
        d = self.d
        n_sel = common.num_selectors
        n_const = cfg.num_constants
        n_pp = common.num_partial_products
        rate = 1 << self.rate_bits
        factor = cfg.max_quotient_degree_factor
        N = common.degree
        rows_per_dev = factor // d
        # halo: the first `rate` rows of the NEXT shard's zs block
        nxt = ppermute([z[:rate] for z in zs_t], mesh, perm=[((i + 1) % d, i) for i in range(d)])
        pi_b = replicate(np.asarray(pi_hash, dtype=np.uint64), mesh)
        betas_b, gammas_b = replicate(betas, mesh), replicate(gammas, mesh)
        alphas_b = replicate(alphas, mesh)
        qv = []
        for i in range(d):
            zs_at, zs_right, partials_at = [], [], []
            for c in range(cfg.num_challenges):
                base = c * (1 + n_pp)
                z_col = zs_t[i][:, base]
                zs_at.append(z_col)
                zs_right.append(torch.cat([z_col[rate:], nxt[i][:, base]]))
                partials_at.append([zs_t[i][:, base + 1 + k] for k in range(n_pp)])
            pre = self.pre_t[i].T.contiguous()
            vanishing = eval_vanishing_torch(
                common, self.coset_points[i], wires_t[i].T.contiguous(),
                pre[:n_sel], pre[n_sel : n_sel + n_const], pre[n_sel + n_const :],
                zs_at, zs_right, partials_at, pi_b[i], betas_b[i], gammas_b[i], alphas_b[i],
                self.l1[i], self.k_is[i],
            )  # per challenge, (M/d,)
            qv.append(torch.stack([gt.mul(vanishing[c], self.z_h_inv[i])
                                   for c in range(cfg.num_challenges)]))  # (nc, M/d)
        q_coeffs = ntt_sharded.four_step_block(qv, self.intt_tw, common.lde_bits, mesh,
                                               inverse=True)
        rows, viol = [], []
        for my, q in enumerate(q_coeffs):
            q = gt.mul(q, self.shift_inv_pows[my][None, :])
            r = q.reshape(cfg.num_challenges, rows_per_dev, N)
            # tail check: the last degree-N block must vanish
            t_idx = my * rows_per_dev + torch.arange(rows_per_dev, device=q.device)
            tail_mask = (t_idx == factor - 1).to(torch.int64)
            viol.append(((r * tail_mask[None, :, None]) != 0).sum().reshape(1))
            rows.append(r)
        return rows, int(psum(viol, mesh)[0][0])

    def factor_rows_to_row_blocks(self, q_rows) -> list:
        """The quotient rows (nc, factor/d, N) a shard, sharded over the
        factor axis -> the (nc * factor, N) matrix row-sharded, row
        c * factor + t.  Shard j's rows are the runs k in [j*nc,
        (j+1)*nc) of factor/d rows each, run k being shard k % d's rows
        at challenge k // d."""
        d, nc = self.d, self.common.config.num_challenges
        return [concat_on([q_rows[k % d][k // d] for k in range(j * nc, (j + 1) * nc)], dev)
                for j, dev in enumerate(self.mesh.devices)]

    # -- stage: openings ---------------------------------------------------------

    def openings_stage(self, pre_c, wires_c, zs_c, q_c, zeta, zeta_right) -> list:
        """Row-sharded coefficient blocks -> five lists of (rows/d, 2)
        blocks: every row at zeta, and the zs rows at zeta_right."""
        N = self.common.degree

        def eval_rows(coeffs, pows):
            c0 = gt.dot_mod(coeffs, pows[None, :, 0], axis=1)
            c1 = gt.dot_mod(coeffs, pows[None, :, 1], axis=1)
            return torch.stack([c0, c1], dim=-1)

        out = [[] for _ in range(5)]
        for i, dev in enumerate(self.mesh.devices):
            pows, pows_r = gt.ext_powers_multi(gt.from_u64(np.stack([zeta, zeta_right]), dev), N)
            for k, (coeffs, p) in enumerate(((pre_c[i], pows), (wires_c[i], pows),
                                             (zs_c[i], pows), (q_c[i], pows),
                                             (zs_c[i], pows_r))):
                out[k].append(eval_rows(coeffs, p))
        return out

    # -- stage: FRI input polynomial ----------------------------------------------

    def fri_input_stage(self, wires_t, zs_t, q_t, apows_all, claim_all,
                        zeta, apows_zs, claim_zs, zeta_right) -> list:
        """-> the FRI input polynomial's values (M/d, 2) a shard."""

        def one(rows, coset_l, apows, claim, z):
            comb0 = gt.dot_mod(rows, apows[None, :, 0], axis=1)
            comb1 = gt.dot_mod(rows, apows[None, :, 1], axis=1)
            comb = torch.stack([comb0, comb1], dim=-1)
            num = gt.ext_sub(comb, claim.expand(comb.shape))
            den = torch.stack([gt.sub(coset_l, z[0]), gt.neg(z[1]).expand(coset_l.shape[0])],
                              dim=-1)
            return gt.ext_mul(num, gt.ext_inverse_vec(den))

        out = []
        for i, dev in enumerate(self.mesh.devices):
            up = [gt.from_u64(a, dev) for a in
                  (apows_all, claim_all, zeta, apows_zs, claim_zs, zeta_right)]
            all_rows = torch.cat([self.pre_t[i], wires_t[i], zs_t[i], q_t[i]], dim=1)
            G = one(all_rows, self.coset_points[i], up[0], up[1], up[2])
            G2 = one(zs_t[i], self.coset_points[i], up[3], up[4], up[5])
            out.append(gt.ext_add(G, G2))
        return out

    # -- stage: FRI fold layer -------------------------------------------------

    def _layer_shardable(self, M: int, arity_bits: int) -> bool:
        A = 1 << arity_bits
        d = self.d
        if A < d or (M // A) % d != 0 or M // (A * d) < 1:
            return False
        ch = fri_mod._layer_cap_height(self.common.config.fri_config, M // A)
        return (1 << ch) >= d

    def fri_layer_stage(self, M: int, arity_bits: int, shift: int):
        """(commit_fn, fold_fn, s_j_inv blocks) for one sharded FRI layer.

        commit_fn(value blocks) -> (groups (M/(A d), A, 2) blocks,
            j-sharded; leaves and their levels j-sharded; the cap on the
            host)
        fold_fn(groups, s_j_inv, beta) -> the next values (M/(A d), 2)
            blocks, j-sharded
        """
        key = ("fri_layer", M, arity_bits, shift)
        if key not in self._stage_cache:
            mesh = self.mesh
            A = 1 << arity_bits
            d = self.d
            ch = fri_mod._layer_cap_height(self.common.config.fri_config, M // A)
            local_cap_h = ch - self.log_d
            W = replicate(fri_mod._fold_matrices(arity_bits), mesh)
            w_M = ntt_mod.root_of_unity(M.bit_length() - 1)
            s_j_inv = shard(
                gl.mul(
                    np.uint64(pow(shift, gl.P - 2, gl.P)),
                    ntt_mod.powers(pow(w_M, gl.P - 2, gl.P), M // A),
                ),
                mesh,
            )

            def commit_fn(value_blocks):
                # local t-planes (A/d, M/A, 2) -> whole groups for a
                # contiguous j chunk: (M/(A*d), A, 2)
                v = all_to_all([x.reshape(A // d, M // A, 2) for x in value_blocks], mesh,
                               split_axis=1, concat_axis=0)  # (A, M/(A*d), 2), axis 0 = global t
                groups = [x.movedim(0, 1) for x in v]
                leaves = [g.reshape(g.shape[0], 2 * A) for g in groups]
                levels = [mk.build_merkle_levels(lv, local_cap_h) for lv in leaves]
                cap = all_gather([lv[-1] for lv in levels], mesh)
                return groups, leaves, levels, gt.to_u64(cap[0])

            def fold_fn(group_blocks, s_j_inv_blocks, beta):
                out = []
                for i, (groups, s_l) in enumerate(zip(group_blocks, s_j_inv_blocks)):
                    dev = groups.device
                    m_loc = groups.shape[0]
                    c = gt.zeros((m_loc, A, 2), dev)
                    for k in range(A):
                        c = gt.add(c, gt.mul(groups[:, k, None, :], W[i][k][None, :, None]))
                    t_pows = []
                    acc = gt.ones(m_loc, dev)
                    for _ in range(A):
                        t_pows.append(acc)
                        acc = gt.mul(acc, s_l)
                    c = gt.mul(c, torch.stack(t_pows, dim=1)[..., None])
                    o = gt.zeros((m_loc, 2), dev)
                    beta_b = gt.from_u64(beta, dev).expand(m_loc, 2)
                    for t in reversed(range(A)):
                        o = gt.ext_add(gt.ext_mul(o, beta_b), c[:, t])
                    out.append(o)
                return out

            self._stage_cache[key] = (commit_fn, fold_fn, s_j_inv)
        return self._stage_cache[key]


def get_sharded_context(common, prover_only, mesh: Mesh) -> ShardedProverContext:
    ctx = getattr(prover_only, "_sharded_ctx", None)
    if ctx is None or ctx._source_mesh is not mesh:
        ctx = ShardedProverContext(common, prover_only, mesh)
        ctx._source_mesh = mesh
        prover_only._sharded_ctx = ctx
    return ctx


def _device_tree(leaves, levels, cap, device) -> DeviceTree:
    """Gather sharded leaves and levels into one DeviceTree on `device`
    (the gathered last level and the replicated cap agree by
    construction)."""
    gathered = [concat_on([lv[k] for lv in levels], device) for k in range(len(levels[0]))]
    if not (gt.to_u64(gathered[-1]) == cap).all():
        raise RuntimeError("the gathered Merkle levels end in another cap than the all_gather's")
    return DeviceTree(leaves=concat_on(leaves, device), levels=gathered, cap=cap)


def sharded_prove(common, prover_only, values, blind_block, public_inputs, pi_hash,
                  fresh_salt, timer, mesh: Mesh) -> ProofWithPublicInputs:
    """Steps 2-5 of the prove pipeline, sharded over `mesh`, from the host
    witness values (the arguments of device_prove).  Byte-identical with
    plonk.device_prover.device_prove.  The blinding salts are drawn on
    shard 0's device, one (M, 4) a commit (wires, zs, quotient), and
    split into point blocks."""
    mark = timer.mark if timer is not None else (lambda name: None)
    cfg = common.config
    fri_cfg = cfg.fri_config
    N = common.degree
    M = common.lde_size
    ctx = get_sharded_context(common, prover_only, mesh)
    base = get_context(common, prover_only, mesh.devices[0])
    dev0 = mesh.devices[0]
    d = ctx.d

    def salt_sharded():
        s = fresh_salt(M)
        return None if s is None else shard(s, mesh)

    # 2. commit wires ---------------------------------------------------------
    wire_matrix = base.assemble_wires(values, blind_block)  # (N, 135) on shard 0
    wires_coeffs, wires_leaves, wires_levels, wires_cap = ctx.commit(
        shard(_pad_rows(wire_matrix.T, d), mesh), cfg.num_wires, salt_sharded(),
        from_coeffs=False,
    )
    wires_t = [lv[:, : cfg.num_wires] for lv in wires_leaves]
    mark("wires commit (sharded)")

    challenger = Challenger()
    challenger.observe_elements(common.circuit_digest)
    challenger.observe_elements(pi_hash)
    challenger.observe_cap(wires_cap)
    betas = challenger.get_n_challenges(cfg.num_challenges)
    gammas = challenger.get_n_challenges(cfg.num_challenges)

    # 3. permutation argument -------------------------------------------------
    w_routed = shard(wire_matrix[:, : cfg.num_routed_wires], mesh)
    zs_pp = ctx.zs_stage(w_routed, betas, gammas)  # (num_zs, N/d) a shard
    num_zs = common.num_zs_partial_products_polys
    zs_rows = all_to_all([_pad_rows(z, d) for z in zs_pp], mesh,
                         split_axis=0, concat_axis=1)  # point -> row sharding
    zs_coeffs, zs_leaves, zs_levels, zs_cap = ctx.commit(
        zs_rows, num_zs, salt_sharded(), from_coeffs=False
    )
    zs_t = [lv[:, :num_zs] for lv in zs_leaves]
    mark("Zs commit (sharded)")
    challenger.observe_cap(zs_cap)
    alphas = challenger.get_n_challenges(cfg.num_challenges)

    # 4. quotient -------------------------------------------------------------
    q_rows, viol = ctx.quotient_stage(wires_t, zs_t, pi_hash, betas, gammas, alphas)
    if viol:
        raise ValueError(
            "constraints unsatisfied: quotient degree overflow "
            "(witness does not satisfy the circuit)"
        )
    num_q = common.num_quotient_polys
    q_coeffs, q_leaves, q_levels, q_cap = ctx.commit(
        ctx.factor_rows_to_row_blocks(q_rows), num_q, salt_sharded(), from_coeffs=True
    )
    q_t = [lv[:, :num_q] for lv in q_leaves]
    mark("quotient commit (sharded)")
    challenger.observe_cap(q_cap)
    zeta = challenger.get_extension_challenge()

    # 5. openings -------------------------------------------------------------
    g = np.uint64(common.subgroup_generator())
    zeta_right = gl.ext_mul(zeta, gl.ext(g, np.uint64(0)))
    opened = [gt.to_u64(gather(o)) for o in ctx.openings_stage(
        ctx.pre_coeffs, wires_coeffs, zs_coeffs, q_coeffs, zeta, zeta_right)]
    openings = Openings(
        preprocessed=opened[0][: ctx.n_pre],
        wires=opened[1][: cfg.num_wires],
        zs_partial=opened[2][:num_zs],
        quotient=opened[3][:num_q],
        zs_partial_right=opened[4][:num_zs],
    )
    mark("openings (sharded)")
    for _tag, vals in openings.batches():
        challenger.observe_elements(vals.ravel())
    fri_alpha = challenger.get_extension_challenge()

    # FRI input polynomial ------------------------------------------------------
    zeta_claims = np.concatenate(
        [openings.preprocessed, openings.wires, openings.zs_partial, openings.quotient]
    )
    apows_all = gl.ext_powers_vec(fri_alpha, zeta_claims.shape[0])
    apows_zs = gl.ext_powers_vec(fri_alpha, openings.zs_partial_right.shape[0])

    def reduce_claims(claims):
        rc = np.zeros(2, dtype=np.uint64)
        for i in range(claims.shape[0] - 1, -1, -1):
            rc = gl.ext_mul(rc, fri_alpha)
            rc = gl.ext_add(rc, claims[i])
        return rc

    values_f = ctx.fri_input_stage(
        wires_t, zs_t, q_t, apows_all, reduce_claims(zeta_claims), zeta,
        apows_zs, reduce_claims(openings.zs_partial_right), zeta_right,
    )  # (M/d, 2) a shard
    mark("FRI input poly (sharded)")

    # FRI commit phase: sharded layers, then the small ones on shard 0 -------
    arities = fri_cfg.reduction_arity_bits(common.degree_bits)
    shift = gl.GENERATOR
    layer_trees, layer_values, groups = [], [], []
    on_shard0 = False
    for ab in arities:
        A = 1 << ab
        Mt = values_f.shape[0] if on_shard0 else values_f[0].shape[0] * d
        ch = fri_mod._layer_cap_height(fri_cfg, Mt // A)
        if not on_shard0 and not ctx._layer_shardable(Mt, ab):
            values_f = gather(values_f)
            on_shard0 = True
        commit_layer, fold_layer, group = base.fri_layer(Mt, ab, shift, ch)
        groups.append(group)
        if on_shard0:
            tree = DeviceTree.from_levels(*commit_layer(values_f))
            challenger.observe_cap(tree.cap)
            beta = challenger.get_extension_challenge()
            layer_trees.append(tree)
            layer_values.append(values_f)
            values_f = fold_layer(values_f, gt.from_u64(beta, dev0))
        else:
            commit_fn, fold_fn, s_j_inv = ctx.fri_layer_stage(Mt, ab, shift)
            g_blocks, leaves, levels, cap = commit_fn(values_f)
            challenger.observe_cap(cap)
            beta = challenger.get_extension_challenge()
            layer_values.append(gather(values_f))
            layer_trees.append(_device_tree(leaves, levels, cap, dev0))
            values_f = fold_fn(g_blocks, s_j_inv, beta)
        shift = pow(shift, A, gl.P)
    final_values = values_f if on_shard0 else gather(values_f)
    mark("FRI commit (sharded)")

    final_dev, final_ok = base.final_poly(final_values, shift)
    if not bool(final_ok):
        raise RuntimeError("FRI final poly degree too high")
    final_poly = gt.to_u64(final_dev)
    challenger.observe_elements(final_poly.ravel())
    pow_witness = base.grind_pow(challenger, fri_cfg.proof_of_work_bits)
    mark("FRI final+PoW")

    # query rounds ----------------------------------------------------------------
    wires_tree = _device_tree(wires_leaves, wires_levels, wires_cap, dev0)
    zs_tree = _device_tree(zs_leaves, zs_levels, zs_cap, dev0)
    q_tree = _device_tree(q_leaves, q_levels, q_cap, dev0)
    indices = challenger.get_indices(fri_cfg.num_query_rounds, common.lde_bits)
    rounds = _assemble_query_rounds(
        groups, arities, [base.pre_tree, wires_tree, zs_tree, q_tree],
        layer_values, layer_trees, indices,
    )
    mark("FRI queries")

    proof = Proof(
        wires_cap=wires_tree.cap,
        zs_partial_cap=zs_tree.cap,
        quotient_cap=q_tree.cap,
        openings=openings,
        fri=FriProof(
            commit_phase_caps=[t.cap for t in layer_trees],
            final_poly=final_poly,
            pow_witness=pow_witness,
            query_rounds=rounds,
        ),
    )
    PROVES["sharded_prove"] += 1
    return ProofWithPublicInputs(proof=proof, public_inputs=public_inputs)
