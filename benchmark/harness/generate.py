"""Inputs from the seed: one pool of read pairs per run, and the cell's
sample files cut from it.

The pool follows ``tests/golden/make_data.py --fast`` (copied, not
imported, and drawn with torch in a few large calls on the card in a
run, on the CPU in the tests): a random amplicon per pair, the forward
read from its 5' end and the reverse read as the reverse complement of
its 3' end, PHRED qualities decaying along the read (``38 - 14 * i /
read_len``, sd 4, clipped to 2..40), a B-cliff (PHRED 2 to the end) on
15% of the reads from a start in the last quarter, and substitution
errors at each base's PHRED rate. A configuration with ``primers_in_reads`` puts its forward
primer at the amplicon's 5' end and its reverse primer's reverse
complement at the 3' end, each degenerate base resolved to a matching
base at random per pair, as the reads of a locus-specific library begin
with the primers. A configuration whose amplicons may be shorter than
the reads names the adapter each read runs into past the amplicon's end
(``adapter_r1``, ``adapter_r2``, each as it reads in its read's 5' to 3'
direction); past the adapter the read goes on in random bases, with
qualities and errors drawn as for the rest of it. Without those keys,
amplicons shorter than the reads are refused. The traffic's ``r2_cut``
cuts each reverse read to a length drawn uniformly from it, as smoke
phase 8's ``cut_r2`` does.

Sample sizes are fixed by the traffic (quantiles of a log-normal); the
seed draws only the reads. Sample ``i`` of ``n`` holds the pool records
from ``round(i * pool / n)`` on, wrapping, as one record slice. The
FASTQ text is built as whole arrays of bytes and written in one call
per file.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
COMP = np.zeros(256, dtype=np.uint8)
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    COMP[_a] = _b
# IUPAC degenerate letters and the bases each stands for
IUPAC = {"A": "A", "C": "C", "G": "G", "T": "T", "R": "AG", "Y": "CT",
         "S": "CG", "W": "AT", "K": "GT", "M": "AC", "B": "CGT",
         "D": "AGT", "H": "ACT", "V": "ACG", "N": "ACGT"}

# CASAVA 1.7+ headers of fixed width: x counts the pool's records
HEAD = b"@M00000:7:000000000-BENCH:1:1101:"
TAG = b"ACGTAC"
X_BASE = 100000
MAX_POOL = 900000  # x stays six digits
# the error rate of each PHRED score
PERR = (10.0 ** (-np.arange(41) / 10.0)).astype(np.float32)


def sample_sizes(samples: dict) -> list[int]:
    """Pairs per sample: the quantiles at (i + 0.5) / count of a
    log-normal with the given median and sigma."""
    n, med, sigma = samples["count"], samples["median_pairs"], \
        samples["sigma"]
    z = NormalDist()
    return [int(round(med * np.exp(sigma * z.inv_cdf((i + 0.5) / n))))
            for i in range(n)]


def _generator(seed: int, stream: int, device):
    """A torch.Generator on ``device`` for one stream of the seed."""
    import torch
    state = np.random.SeedSequence([seed, stream]).generate_state(
        1, np.uint64)[0]
    g = torch.Generator(device=device)
    g.manual_seed(int(state))
    return g


def _resolve(primer: str, g, n: int):
    """[n, len] bytes: each degenerate base of ``primer`` resolved to one
    of its bases at random per row."""
    import torch
    dev = g.device
    cols = []
    for ch in primer:
        opts = torch.tensor(list(IUPAC[ch].encode()), dtype=torch.uint8,
                            device=dev)
        cols.append(opts[torch.randint(0, len(opts), (n,), generator=g,
                                       device=dev)])
    return torch.stack(cols, dim=1)


def _corrupt(g, reads, rl):
    """make_data.py --fast's quality profile and substitution errors."""
    import torch
    dev = g.device
    n = reads.shape[0]
    pos = torch.arange(rl, device=dev)
    mean = 38 - 14 * pos.to(torch.float32) / rl
    q = (mean + 4 * torch.randn((n, rl), generator=g, device=dev)).clamp(
        2, 40).to(torch.int8)
    cliff = torch.rand(n, generator=g, device=dev) < 0.15
    cliff_start = torch.randint(rl * 3 // 4, rl + 1, (n,), generator=g,
                                device=dev)
    q[cliff[:, None] & (pos[None, :] >= cliff_start[:, None])] = 2
    perr = torch.tensor(PERR, device=dev)
    err = torch.rand((n, rl), generator=g, device=dev) < perr[q.long()]
    sub = torch.tensor(BASES, device=dev)[
        torch.randint(0, 4, (n, rl), generator=g, device=dev)]
    return torch.where(err, sub, reads), (q + 33).to(torch.uint8)


@dataclass
class Pool:
    """The run's read pairs: [n, read_len] bases and qualities of each
    read, and each reverse read's length."""
    seq: tuple
    qual: tuple
    rlen: np.ndarray

    @property
    def n(self):
        return len(self.rlen)


def make_pool(config: dict, traffic: dict, n: int, seed: int,
              device="cpu") -> Pool:
    """The pool, drawn on ``device`` (the card in a run, in a few large
    calls) and brought to the host."""
    import torch
    if n > MAX_POOL:
        raise ValueError("a pool holds at most %d pairs" % MAX_POOL)
    g = _generator(seed, 1, device)
    rl = config["read_len"]
    amp_min, amp_max = config["amplicon"]
    adapters = (config.get("adapter_r1"), config.get("adapter_r2"))
    if amp_min < rl and not all(adapters):
        raise ValueError("amplicons shorter than the reads, and no "
                         "adapter_r1 and adapter_r2 to read through into")
    bases = torch.tensor(BASES, device=device)
    comp = torch.tensor(COMP, device=device)
    amp_len = torch.randint(amp_min, amp_max + 1, (n,), generator=g,
                            device=device)
    amp = bases[torch.randint(0, 4, (n, max(amp_max, rl)), generator=g,
                              device=device)]
    rows = torch.arange(n, device=device)[:, None]
    if config.get("primers_in_reads"):
        fwd = _resolve(config["forward_primer"], g, n)
        rev = comp[_resolve(config["reverse_primer"], g, n).long()].flip(1)
        amp[:, :fwd.shape[1]] = fwd
        amp[rows, amp_len[:, None] - rev.shape[1]
            + torch.arange(rev.shape[1], device=device)] = rev
    pos = torch.arange(rl, device=device)[None, :]
    ridx = (amp_len[:, None] - 1 - pos).clamp(min=0)
    pairs = [amp[:, :rl], comp[amp[rows, ridx].long()]]
    if amp_min < rl:
        # read-through: past the amplicon's end each read runs into its
        # adapter, then into random bases (a stream of its own, so that
        # configurations without read-through draw as they always did)
        gt = _generator(seed, 4, device)
        past = (pos - amp_len[:, None]).clamp(min=0)
        for which, adapter in enumerate(adapters):
            ad = torch.tensor(list(adapter.encode()), dtype=torch.uint8,
                              device=device)
            tail = torch.cat([ad.expand(n, len(ad)), bases[torch.randint(
                0, 4, (n, rl), generator=gt, device=device)]], dim=1)
            pairs[which] = torch.where(pos < amp_len[:, None],
                                       pairs[which], tail.gather(1, past))
    seq, qual = [], []
    for reads in pairs:
        s, q = _corrupt(g, reads, rl)
        seq.append(s.cpu().numpy())
        qual.append(q.cpu().numpy())
    rlen = np.full(n, rl, dtype=np.int64)
    cut = traffic.get("r2_cut")
    if cut:
        rlen = torch.randint(cut[0], cut[1] + 1, (n,),
                             generator=_generator(seed, 2, device),
                             device=device).cpu().numpy()
    return Pool(tuple(seq), tuple(qual), rlen)


def _headers(idx: np.ndarray, which: int) -> np.ndarray:
    """[n, width] bytes of the records' fixed-width headers."""
    n = len(idx)

    def digits(v):
        v = np.asarray(v, dtype=np.int64)
        return (48 + (v[:, None] // 10 ** np.arange(5, -1, -1)) % 10
                ).astype(np.uint8)

    x = X_BASE + idx
    y = X_BASE + (idx * 37) % MAX_POOL
    tail = np.frombuffer(b" %d:N:0:%s" % (which + 1, TAG), dtype=np.uint8)
    return np.concatenate([
        np.broadcast_to(np.frombuffer(HEAD, np.uint8), (n, len(HEAD))),
        digits(x), np.full((n, 1), ord(":"), np.uint8), digits(y),
        np.broadcast_to(tail, (n, len(tail)))], axis=1)


def fastq_bytes(pool: Pool, idx: np.ndarray, which: int):
    """(FASTQ text, byte offset of each record) of pool records ``idx``
    for read ``which`` (0 forward, 1 reverse)."""
    n = len(idx)
    seq, qual = pool.seq[which][idx], pool.qual[which][idx]
    rl = seq.shape[1]
    lens = pool.rlen[idx] if which else np.full(n, rl, dtype=np.int64)
    nl = np.full((n, 1), 10, np.uint8)
    rows = np.concatenate(
        [_headers(idx, which), nl, seq,
         np.broadcast_to(np.frombuffer(b"\n+\n", np.uint8), (n, 3)), qual,
         nl], axis=1)
    head = rows.shape[1] - 2 * rl - 5  # the header's width
    rec_len = head + 2 * lens + 5
    if (lens == rl).all():
        data = rows.tobytes()
    else:
        col = np.arange(rows.shape[1])[None, :]
        s0 = head + 1
        q0 = s0 + rl + 3
        keep = ~(((col >= s0 + lens[:, None]) & (col < s0 + rl))
                 | ((col >= q0 + lens[:, None]) & (col < q0 + rl)))
        data = rows[keep].tobytes()
    offsets = np.zeros(n, dtype=np.int64)
    np.cumsum(rec_len[:-1], out=offsets[1:])
    return data, offsets


@dataclass
class Sample:
    """One sample's FASTQ pair on disk and what the check needs of it."""
    index: int
    paths: tuple
    pairs: int
    offsets: tuple  # byte offset of each record in each file
    bucket: tuple  # (Lb, O) of its batches by the engine's rule


def bucket(flen: int, rlen: int, L: int = 512, step: int = 128) -> tuple:
    """The engine's (Lb, O) shape bucket for reads at most ``flen`` and
    ``rlen`` long, with no -O (assembler.py _pre)."""
    def up(v):
        return -(-max(v, 1) // step) * step
    O = min(L, up(min(flen, rlen)))
    return (min(L, max(up(max(flen, rlen)), O)), O)


def write_samples(pool: Pool, config: dict, sizes: list[int],
                  dest: str) -> list[Sample]:
    out = []
    for i, n in enumerate(sizes):
        start = int(round(i * pool.n / len(sizes)))
        idx = (start + np.arange(n)) % pool.n
        paths, offs = [], []
        for which in (0, 1):
            data, off = fastq_bytes(pool, idx, which)
            path = os.path.join(dest, "s%02d_%d.fastq" % (i, which + 1))
            with open(path, "wb") as fh:
                fh.write(data)
            paths.append(path)
            offs.append(off)
        rl = config["read_len"]
        out.append(Sample(i, tuple(paths), n, tuple(offs),
                          bucket(rl, int(pool.rlen[idx].max()))))
    return out
