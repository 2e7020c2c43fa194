"""The least time the card could take for the Poseidon work a proof
needs, counted from the circuit's shapes and the proof itself, whatever
launches the program makes: the leaf hashes and tree nodes of the wires,
zs and quotient trees (salt columns included under zero knowledge) and
of every FRI layer, down to each cap; the challenger's duplexes; and the
proof-of-work candidates below the proof's nonce.  The preprocessed tree
is set-up work and is left out.

The model (the port's benches/kernels.py): bytes at 3.35 TB/s (NVIDIA's
data sheet, H100 SXM), 32-bit integer multiplies at 64 a clock on each SM
(compute capability 9.0) times the card's SMs and its top SM clock; a
leaf hash reads its row and writes a digest, a node reads two digests and
writes one, a lone permutation reads and writes a state."""

from __future__ import annotations

import subprocess

PEAK_BYTES = 3.35e12
INT_MULS_PER_CLOCK_PER_SM = 64
H100_SMS, H100_CLOCK_HZ = 132, 1.98e9
INT_MULS_PER_MULMOD = 5
MULMODS_PER_PERM = 4 * (8 * 12 + 22)
INT_MULS_PER_PERM = INT_MULS_PER_MULMOD * MULMODS_PER_PERM + 30 * (144 * 2 + 12)
RATE, DIGEST, STATE = 8, 4, 12


def _tree(rows: int, width: int, cap_height: int) -> tuple:
    """(permutations, bytes) of hashing `rows` leaves of `width` words and
    the tree above them down to its cap."""
    leaf = -(-width // RATE) if width > DIGEST else 0
    cap = 1 << min(cap_height, rows.bit_length() - 1)
    nodes = rows - cap
    return (rows * leaf + nodes,
            8 * (rows * (width + DIGEST) + nodes * 3 * DIGEST))


def duplexes(c) -> int:
    """The challenger's permutations in one proof's transcript, from the
    shapes alone (a verifier replays the same ones)."""
    state = {"in": 0, "out": 0, "perms": 0}

    def duplex():
        state["in"], state["out"] = 0, RATE
        state["perms"] += 1

    def observe(n):
        for _ in range(n):
            state["out"] = 0
            state["in"] += 1
            if state["in"] == RATE:
                duplex()

    def draw(n):
        for _ in range(n):
            if state["in"] or not state["out"]:
                duplex()
            state["out"] -= 1

    cap = 4 << min(c.cap_height, c.lde_bits)
    observe(8)
    observe(cap)
    draw(2 * c.num_challenges)
    observe(cap)
    draw(c.num_challenges)
    observe(cap)
    draw(2)
    observe(2 * (c.num_preprocessed + c.num_wires + c.num_zs + c.num_quotient))
    observe(2 * c.num_zs)
    draw(2)
    bits = c.lde_bits
    for ab in c.arities():
        bits -= ab
        observe(4 << min(c.cap_height, bits))
        draw(2)
    observe(2 << (c.degree_bits - sum(c.arities())))
    observe(1)
    draw(1 + c.num_queries)
    return state["perms"]


def proof_work(c, pow_witness: int) -> tuple:
    """(permutations, bytes) of the Poseidon work of one proof of circuit
    c (a reference.formats.Common) whose nonce is pow_witness."""
    rows = 1 << c.lde_bits
    perms = nbytes = 0
    for width in (c.num_wires + c.salt, c.num_zs + c.salt, c.num_quotient + c.salt):
        p, b = _tree(rows, width, c.cap_height)
        perms, nbytes = perms + p, nbytes + b
    for ab in c.arities():
        rows >>= ab
        p, b = _tree(rows, 2 << ab, c.cap_height)
        perms, nbytes = perms + p, nbytes + b
    lone = duplexes(c) + pow_witness
    return perms + lone, nbytes + lone * 2 * 8 * STATE


def card_rates() -> dict:
    """The card's 32-bit multiply rate and the model's inputs: SMs from
    torch, the top SM clock from nvidia-smi (else the H100 SXM's)."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count or H100_SMS
    clock = H100_CLOCK_HZ
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode == 0 and smi.stdout.strip().splitlines()[0].strip().isdigit():
        clock = float(smi.stdout.strip().splitlines()[0]) * 1e6
    return {"sms": sms, "clock_hz": clock,
            "int_muls_per_s": INT_MULS_PER_CLOCK_PER_SM * sms * clock, "bytes_per_s": PEAK_BYTES}


def least_seconds(perms: float, nbytes: float, rates: dict) -> float:
    return max(perms * INT_MULS_PER_PERM / rates["int_muls_per_s"], nbytes / rates["bytes_per_s"])
