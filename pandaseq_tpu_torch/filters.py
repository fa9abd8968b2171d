"""Validation-module (filter) layer: every reference plugin, natively.

The reference loads filter plugins as libltdl shared objects with
``PandaPreCheck`` (raw pair, before primers/alignment — assembler.c:259)
and ``PandaCheck`` (assembled result — assembler.c:339) hooks
(module.c:227-321). Here the same modules are a Python registry; user
modules register with :func:`register` (the ``pandaxs`` analogue is
"write a Python function").

Batch note: prechecks/checks are host-side predicates over scalar results
(they run on the small [B] result metadata, not the O(L^2) device work);
`min_phred`'s per-base scan is vectorized numpy.

Each opener reproduces its plugin's argument grammar and error messages
(plugin_*.c cited per function).

The PyTorch port's copy of ``pandaseq_tpu/filters.py``, unchanged but for its
imports; the port imports nothing of ``pandaseq_tpu``.
"""

from __future__ import annotations

import math
import os

import numpy as np

from . import seqid as seqid_mod
from .nt import nt_from_ascii, nt_from_ascii_complement, result_phred

MAX_LEN = 450


class ModuleError(Exception):
    """Plugin refused to initialize (OPEN returned false)."""


class Module:
    """A loaded filter module (pandaseq-module.h)."""

    def __init__(self, name: str, precheck=None, check=None, destroy=None,
                 args: str | None = None, api: int = 3, check_batch=None,
                 precheck_batch=None):
        self.name = name
        self.precheck = precheck  # (sid, fwd_nt, fwd_q, flen, rev_nt,
        #                            rev_q, rlen) -> bool
        # optional vectorized precheck: (Batch, alive_mask) -> bool[B]
        # pass-verdicts (or None to fall back to the scalar precheck for
        # this batch). Must be side-effect free per row: verdicts for
        # rows outside alive_mask are ignored, and rows may be computed
        # speculatively. Stateful stream gates (after/before) must NOT
        # define this.
        self.precheck_batch = precheck_batch
        self.check = check  # (result) -> bool
        # optional vectorized form: (ResultBatchView, sel_mask) ->
        # bool[B]; semantically identical to mapping ``check`` over the
        # selected rows — lets module configurations ride the batched
        # emit fast path (assembler._emit_from_native).
        # CONTRACT: verdicts must be computed strictly per-row from
        # rows where sel_mask is true — the view's ascii/pidx planes
        # are reused scratch, so rows outside sel hold a previous
        # batch's bytes (cross-row aggregates over the full batch
        # would silently read them).
        self.check_batch = check_batch
        self.destroy = destroy
        self.args = args
        self.api = api
        self.rejected = 0  # module.c:124-154

    def __repr__(self):
        return f"Module({self.name!r})"


def parse_key_values(args: str | None, processor) -> bool:
    """panda_parse_key_values (args.c:601-642): ``key=value,key=value``;
    empty args is valid."""
    if args is None or args == "":
        return True
    for part in args.split(","):
        if "=" not in part:
            key, value = part, ""
        else:
            key, value = part.split("=", 1)
        if not processor(key, value):
            return False
    return True


# ---------------------------------------------------------------------------
# Built-in plugins
# ---------------------------------------------------------------------------

def _open_min_phred(args, logger):
    """plugin_min_phred.c: every output base's re-derived PHRED >= value."""
    if not args:
        logger.write_str("Need a number for a PHRED score.\n")
        raise ModuleError("min_phred")
    try:
        value = int(args, 10)
    except ValueError:
        value = None
    if value is None or value < 0 or value > 127:
        logger.write_str("PHRED score must be a number between 0 and 127.\n")
        raise ModuleError("min_phred")

    def check(res):
        if res.sequence_length == 0:
            return True
        ph = result_phred(res.sequence_p[:res.sequence_length])
        return bool(np.all(ph >= value))

    def check_batch(view, sel):
        ph = result_phred(view.p())  # [B, L2]
        pos = np.arange(ph.shape[1])[None, :]
        masked = (ph >= value) | (pos >= view.sequence_length[:, None])
        return masked.all(axis=1)

    return Module("min_phred", check=check, args=args,
                  check_batch=check_batch)


def _open_min_overlapbits(args, logger):
    """plugin_min_overlapbits.c: estimated_overlap_probability >= bits*ln2
    (Cole 2013); default 15 bits."""
    bits_saved = 15 * math.log(2)
    if args is not None:
        try:
            bits_saved = float(args) * math.log(2)
        except ValueError:
            logger.write_str("bits_saved")
            raise ModuleError("min_overlapbits")
        if bits_saved < 0:
            logger.write_str("Value %f out of range for bits saved "
                             "cut-off." % (bits_saved / math.log(2)))
            raise ModuleError("min_overlapbits")

    def check(res):
        return bits_saved <= res.estimated_overlap_probability

    return Module(
        "min_overlapbits", check=check, args=args,
        check_batch=lambda view, sel:
            bits_saved <= view.estimated_overlap_probability)


def _open_empty(args, logger):
    """plugin_empty.c: drop zero-length output sequences."""
    if args:
        logger.write_str("No arguments allowed to empty filter.")
        raise ModuleError("empty")
    return Module("empty", check=lambda res: res.sequence_length > 0,
                  check_batch=lambda view, sel: view.sequence_length > 0)


def _open_completely_miss_the_point(args, logger):
    """plugin_completely_miss_the_point.c: overlap mismatches <= limit."""
    if not args:
        logger.write_str("Please supply the maximum allowed mismatches.\n")
        raise ModuleError("completely_miss_the_point")
    try:
        mm = int(args, 10)
    except ValueError:
        mm = -1
    if mm < 0 or mm > MAX_LEN:
        logger.write_str("Bad maximum allowed mismatches.\n")
        raise ModuleError("completely_miss_the_point")
    return Module("completely_miss_the_point",
                  check=lambda res: res.overlap_mismatches <= mm,
                  args=args,
                  check_batch=lambda view, sel:
                      view.overlap_mismatches <= mm)


def _open_validtag(args, logger):
    """plugin_validtag.c: tag must prefix-match one of the given tags; all
    tags must be the same length."""
    if args is None:
        logger.write_str("ERR\tVALTAG\tNOTAGS")
        raise ModuleError("validtag")
    tags = args.split(":")
    taglen = len(tags[0])
    if taglen == 0:
        logger.write_str("ERR\tVALTAG\tNOTAGS")
        raise ModuleError("validtag")
    for t in tags[1:]:
        if len(t) != taglen:
            logger.write_str("ERR\tVALTAG\tBADTLEN\t%d != %d %s"
                             % (len(t), taglen, t))
            raise ModuleError("validtag")

    tagset = set(tags)

    def precheck(sid, *_):
        tag = getattr(sid, "tag", None)
        if not tag:
            return False
        return tag[:taglen] in tagset

    def precheck_batch(batch, alive):
        return np.fromiter(
            ((getattr(p.sid, "tag", None) or "")[:taglen] in tagset
             and bool(getattr(p.sid, "tag", None))
             for p in batch.pairs), dtype=bool, count=len(batch.pairs))

    return Module("validtag", precheck=precheck, args=args,
                  precheck_batch=precheck_batch)


def _open_filter(args, logger):
    """plugin_filter.c: keep only IDs listed in a file (PandaSet)."""
    import sys
    if not args:
        fh = sys.stdin
        close = False
    else:
        try:
            fh = open(args, "r")
        except OSError as e:
            logger.write_str("%s: %s" % (args, e.strerror))
            raise ModuleError("filter")
        close = True
    idset = set()
    for line in fh:
        line = line.rstrip("\n")
        s = line[1:] if line.startswith("@") else line
        direction, sid, _ = seqid_mod.parse(s, seqid_mod.TAG_OPTIONAL)
        if direction == 0:
            logger.write_str("ERR\tFILTER\tBAD\t%s" % line)
            if close:
                fh.close()
            raise ModuleError("filter")
        idset.add(str(sid))
    if close:
        fh.close()

    def precheck(sid, *_):
        return str(sid) in idset

    def precheck_batch(batch, alive):
        return np.fromiter((str(p.sid) in idset for p in batch.pairs),
                           dtype=bool, count=len(batch.pairs))

    return Module("filter", precheck=precheck, args=args,
                  precheck_batch=precheck_batch)


def _open_after(args, logger):
    """plugin_after.c: pass sequences at/after the marker id."""
    return _open_positional(args, logger, "AFTER", after=True)


def _open_before(args, logger):
    """plugin_before.c: pass sequences strictly before the marker id."""
    return _open_positional(args, logger, "BEFORE", after=False)


def _open_positional(args, logger, name, after):
    if args is None:
        logger.write_str("ERR\t%s\tNO ID" % name)
        raise ModuleError(name.lower())
    s = args[1:] if args.startswith("@") else args
    direction, marker, _ = seqid_mod.parse(s, seqid_mod.TAG_OPTIONAL)
    if direction == 0:
        logger.write_str("ERR\t%s\tBAD\t%s" % (name, args))
        raise ModuleError(name.lower())
    state = {"seen": False}
    marker_s = str(marker)

    def precheck(sid, *_):
        if str(sid) == marker_s:
            state["seen"] = True
        return state["seen"] if after else not state["seen"]

    return Module(name.lower(), precheck=precheck, args=args)


def _open_other_primer(args, logger):
    """plugin_other_primer.c: reject reads matching a second primer via
    panda_compute_offset_qual(log 0.9, 0.01, ...)."""
    from . import oracle
    if not args:
        raise ModuleError("other_primer")
    c = args[0]
    if c in "fp":
        forward = True
    elif c in "rq":
        forward = False
    else:
        logger.write_str("ERR\tOTHER_PRIMER\tINIT\tExpected f or r, but "
                         "got %c." % c)
        raise ModuleError("other_primer")
    if len(args) < 2 or args[1] != ":":
        logger.write_str("ERR\tOTHER_PRIMER\tINIT\tExpected :, but got "
                         "%c." % (args[1] if len(args) > 1 else "\0"))
        raise ModuleError("other_primer")
    primer_str = args[2:]
    if not primer_str:
        logger.write_str("ERR\tOTHER_PRIMER\tINIT\tPrimer cannot be "
                         "empty.")
        raise ModuleError("other_primer")
    conv = nt_from_ascii if forward else nt_from_ascii_complement
    primer = conv(np.frombuffer(primer_str.encode(), dtype=np.uint8))
    if np.any(primer == 0):
        bad = primer_str[int(np.argmax(primer == 0))]
        logger.write_str("ERR\tOTHER_PRIMER\tBADNT\t%c" % bad)
        raise ModuleError("other_primer")
    thr = math.log(0.9)

    def precheck(sid, fwd_nt, fwd_q, flen, rev_nt, rev_q, rlen):
        if forward:
            nt, q, ln = fwd_nt, fwd_q, flen
        else:
            nt, q, ln = rev_nt, rev_q, rlen
        return oracle.compute_offset_qual(thr, 0.01, not forward, nt, q,
                                          ln, primer) == 0

    def precheck_batch(batch, alive):
        # one native batch scan over the reversed frames (the same
        # kernel the -p/-q primer stage uses); the reverse-read scan is
        # the back-to-front mode (offset.c:103-112 'reverse')
        from .io import native
        nt = batch.fwd_nt if forward else batch.rev_nt
        q = batch.fwd_q if forward else batch.rev_q
        lens = batch.flen if forward else batch.rlen
        off = native.compute_offsets(nt, q, lens, primer, thr, 0.01,
                                     rev_scan=not forward)
        return None if off is None else off == 0

    return Module("other_primer", precheck=precheck, args=args,
                  precheck_batch=precheck_batch)


def _open_overlap_stat(args, logger):
    """plugin_overlap_stat.c: histogram of overlaps_examined, printed as
    STAT EXAMINED at teardown."""
    if args:
        logger.write_str("ERR\tOVERLAPSTAT")
        raise ModuleError("overlap_stat")
    counts = np.zeros(MAX_LEN, dtype=np.int64)

    def check(res):
        # examined can exceed MAX_LEN under -O > 450; the reference
        # writes past its malloc'd counts[] there (heap overflow UB,
        # plugin_overlap_stat.c:23) — we clamp into the last bucket
        # in both the scalar and batched paths instead
        if res.overlaps_examined > 0:
            counts[min(res.overlaps_examined, MAX_LEN) - 1] += 1
        return True

    def destroy():
        mx = MAX_LEN - 1
        while mx > 0 and counts[mx] == 0:
            mx -= 1
        logger.write_str("STAT\tEXAMINED "
                         + " ".join(str(int(c)) for c in counts[:mx + 1]))

    def check_batch(view, sel):
        ex = view.overlaps_examined[sel]
        ex = ex[ex > 0]
        np.add.at(counts, np.minimum(ex - 1, MAX_LEN - 1), 1)
        return np.ones(len(view.overlaps_examined), dtype=bool)

    return Module("overlap_stat", check=check, destroy=destroy,
                  check_batch=check_batch)


def _open_pear_test(args, logger):
    """plugin_pear_test.c: PEAR §2.2 false-positive statistical test.

    Faithful-bug: the reference's OPEN passes the *logger* as the
    key_processor's user data (plugin_pear_test.c:95 `key_processor,
    logger` with `(char *) data + token[it].holder`), so parsed
    alpha/beta/cutoff land in the logger object, never in `struct data`
    — arguments are validated but silently IGNORED; the check always
    runs with the defaults alpha=1, beta=-1, cutoff=0.01."""

    def processor(key, value):
        if key not in ("alpha", "beta", "cutoff"):
            logger.write_str("Unknown setting: /%s/" % key)
            return False
        try:
            float(value)
        except ValueError:
            logger.write_str("%s: trailing garbage: %s" % (key, value))
            return False
        return True

    if not parse_key_values(args, processor):
        raise ModuleError("pear_test")
    alpha, beta, cutoff = 1.0, -1.0, 0.01
    ln25, ln75 = math.log(0.25), math.log(0.75)
    # lgamma(n+1) staged through math.lgamma (glibc — the exact values
    # the reference plugin's lgamma calls produce)
    _lg = np.array([math.lgamma(n + 1.0) for n in range(MAX_LEN + 2)])
    # T[i, l] = the plugin's ascending-k partial sum
    # sum_{k<l} C(i,k) 0.25^k 0.75^(i-k) with the same f64 term
    # expression and accumulation order (cumsum is sequential); rows
    # fill lazily. l_i <= i-1 always (oes <= overlap <= i).
    T = np.zeros((MAX_LEN + 2, MAX_LEN + 2))
    have = np.zeros(MAX_LEN + 2, dtype=bool)

    def _row(i):
        if not have[i]:
            k = np.arange(i)
            icho = (_lg[i] - _lg[k]) - _lg[i - k]
            args = icho + k * ln25 + (i - k) * ln75
            # math.exp, not np.exp: the SIMD exp differs from libm's in
            # the last ulp, and the reference plugin calls libm
            import itertools
            terms = [math.exp(v) for v in args.tolist()]
            T[i, 1:i + 1] = np.fromiter(
                itertools.accumulate(terms), dtype=np.float64, count=i)
            have[i] = True

    def _sum(i, l_i):
        if i < 0 or i > MAX_LEN:
            # out-of-table i (cannot occur via the check loop: i <
            # min(flen, rlen) <= MAX_LEN) — exact scalar fallback
            v = 0.0
            for k in range(max(l_i, 0)):
                icho = (math.lgamma(i + 1) - math.lgamma(k + 1)
                        - math.lgamma(i - k + 1))
                v += math.exp(icho + k * ln25 + (i - k) * ln75)
            return v
        _row(i)
        return float(T[i, min(max(l_i, 0), i)])

    def check(res):
        product = 1.0
        oes = (alpha * (res.overlap - res.overlap_mismatches)
               + beta * res.overlap_mismatches)
        i = res.overlap
        while i < res.forward_length and i < res.reverse_length:
            l_i = int(math.ceil((oes - beta * i) / (alpha - beta))) - 1
            product *= _sum(i, l_i)
            i += 1
        return cutoff > 1 - product * product

    def check_batch(view, sel):
        """Vectorized: the same ascending-i f64 product
        (multiply.reduceat applies the ufunc left-to-right within each
        segment, matching the C loop's order) over the exact cumulative
        binomial table."""
        B = len(view.overlap)
        out = np.ones(B, dtype=bool)
        rows = np.flatnonzero(sel)
        if len(rows) == 0:
            return out
        o = view.overlap[rows].astype(np.int64)
        mmx = view.overlap_mismatches[rows].astype(np.int64)
        hi = np.minimum(view.forward_length[rows],
                        view.reverse_length[rows]).astype(np.int64)
        oes = alpha * (o - mmx) + beta * mmx
        n_i = np.maximum(hi - o, 0)
        if n_i.max(initial=0) > 0:
            lo_i, hi_i = int(o[n_i > 0].min()), int(hi.max())
            for i in range(lo_i, min(hi_i, MAX_LEN + 1)):
                _row(i)
            from .io import native as _native
            nat = _native.pear_test_check(T, o, mmx, hi, alpha, beta,
                                          cutoff)
            if nat is not None:
                out[rows] = nat
                return out
        prod = np.ones(len(rows), dtype=np.float64)
        nz = np.flatnonzero(n_i > 0)
        if len(nz):
            o2, n2, oes2 = o[nz], n_i[nz], oes[nz]
            seg_starts = np.cumsum(n2) - n2
            offs = np.arange(int(n2.sum())) - np.repeat(seg_starts, n2)
            ii = np.repeat(o2, n2) + offs
            l_i = np.ceil((np.repeat(oes2, n2) - beta * ii)
                          / (alpha - beta)).astype(np.int64) - 1
            # i < min(flen, rlen) <= MAX_LEN; l_i <= i - 1 by algebra
            for i in np.unique(ii):
                _row(int(i))
            vals = T[ii, np.clip(l_i, 0, ii)]
            prod[nz] = np.multiply.reduceat(vals, seg_starts)
        out[rows] = cutoff > 1 - prod * prod
        return out

    return Module("pear_test", check=check, args=args,
                  check_batch=check_batch)


def _open_sample(args, logger):
    """plugin_sample.c: documented do-nothing template."""
    return Module("sample", check=lambda res: True, args=args)


# CLI-synthesized in-code modules (args_assembler.c:106-303)

def degenerates_module() -> Module:
    """-N: no degenerate bases in output (args_assembler.c:106-153)."""
    return Module("DEGENERATE", check=lambda res: res.degenerates == 0,
                  check_batch=lambda view, sel: view.degenerates == 0)


def short_module(minlen: int) -> Module:
    """-l: minimum output length (args_assembler.c:233-266)."""
    return Module("SHORT",
                  check=lambda res: res.sequence_length >= minlen,
                  check_batch=lambda view, sel:
                      view.sequence_length >= minlen)


def long_module(maxlen: int) -> Module:
    """-L: maximum output length (args_assembler.c:268-303)."""
    return Module("LONG", check=lambda res: res.sequence_length <= maxlen,
                  check_batch=lambda view, sel:
                      view.sequence_length <= maxlen)


REGISTRY = {
    "min_phred": (_open_min_phred,
                  "Ensure the minimum score of all the output bases is "
                  "above a certain PHRED value.", "min_phred:value"),
    "min_overlapbits": (_open_min_overlapbits,
                        "Check the number of bits saved (Cole 2013).",
                        "min_overlapbits:15"),
    "empty": (_open_empty, "Drops empty (zero-length) output sequences.",
              "empty"),
    "completely_miss_the_point": (
        _open_completely_miss_the_point,
        "Filter out sequences that have mismatches in the overlap region.",
        "completely_miss_the_point:mismatches"),
    "validtag": (_open_validtag,
                 "Filter out any sequences without a valid index tag.",
                 "validtag:TAG1:TAG2:TAG3"),
    "filter": (_open_filter,
               "Filters sequences based on the contents of a file of ids, "
               "one sequence ID per line.", "filter:file"),
    "after": (_open_after,
              "Include only sequences in the one after the provided "
              "sequence", "after:sequenceid"),
    "before": (_open_before,
               "Include only sequences in the one before the provided "
               "sequence", "before:sequenceid"),
    "other_primer": (_open_other_primer,
                     "Remove reads with another primer. Use f for forward, "
                     "r for reverse.", "other_primer:[fr]:NNNNN"),
    "overlap_stat": (_open_overlap_stat,
                     "Produce statistics on the overlaps examined. Somewhat "
                     "interesting to see the efficiency of the k-mer table.",
                     "overlap_stat"),
    "pear_test": (_open_pear_test,
                  "Use the statistical test from PEAR (Zhang 2013)",
                  "pear_test:alpha=1.0,beta=-1.0,cutoff=0.01"),
    "sample": (_open_sample, "A demonstration module that does nothing.",
               "sample"),
}


def register(name: str, opener, description: str = "", usage: str = ""):
    """Register a user filter module (the pandaxs analogue)."""
    REGISTRY[name] = (opener, description, usage or name)


def load_module(spec: str, logger) -> Module:
    """panda_module_load (module.c:227-298): ``name`` or ``name:args``.

    Like lt_dlopenext, a name containing a path separator (or ending in
    .py) loads a user module FILE — the pandaxs analogue: a Python file
    exporting ``api = 3`` (module.c:262-269 requires PANDA_API) and
    ``opener(args, logger) -> Module`` (the plugin OPEN contract,
    pandaseq-plugin.h:33). The extension is appended if missing."""
    if ":" in spec:
        name, args = spec.split(":", 1)
    else:
        name, args = spec, None
    if os.sep in name or name.endswith(".py"):
        path = name if os.path.isfile(name) else name + ".py"
        if not os.path.isfile(path):
            logger.write_str("Unable to open module %s." % name)
            raise ModuleError(name)
        import importlib.util
        try:
            mspec = importlib.util.spec_from_file_location(
                "psq_user_module_%s" % os.path.basename(path)[:-3],
                path)
            pymod = importlib.util.module_from_spec(mspec)
            mspec.loader.exec_module(pymod)
        except ModuleError:
            raise
        except Exception as e:  # lt_dlopenext failure -> clean error
            logger.write_str("Unable to open module %s. (%s)"
                             % (name, e))
            raise ModuleError(name)
        if getattr(pymod, "api", None) != 3:
            logger.write_str(
                "Module %s is using an incompatible API version."
                % name)
            raise ModuleError(name)
        opener = getattr(pymod, "opener", None)
        mod = opener(args, logger) if callable(opener) else None
        if not isinstance(mod, Module):
            logger.write_str("Unable to open module %s." % name)
            raise ModuleError(name)
        return mod
    entry = REGISTRY.get(name)
    if entry is None:
        logger.write_str("Unable to open module %s." % name)
        raise ModuleError(name)
    mod = entry[0](args, logger)
    mod.name = name if mod.name != name.upper() else mod.name
    return mod


def show_all(logger):
    """module_show_all (module.c:443-451): list modules with usage+help."""
    for name in sorted(REGISTRY):
        _, desc, usage = REGISTRY[name]
        logger.write_str("%s\n\t%s" % (usage, desc))
