"""pandaseq-diff (main-diff.c / diff.c): assemble the same pair stream
with two configurations (control vs experimental) and report
gained/lost/length/nucleotide/quality differences.

The port's own copy of ``pandaseq_tpu/cli/diffcmd.py``: the same
sectioned argv, report lines and exit status, with both passes on the
port's ``BatchAssembler`` (device from ``PANDASEQ_TORCH_DEVICE``, default
``cuda``, as the CLI takes it; engine as the CLI resolves it), in
1024-pair batches. Every pair is read through the Python reader
(``io/fastq.read_pairs``) and held in memory, so inputs stay modest.

Usage: pandaseq-diff <common flags> -- <control flags> -- <experimental
flags>; exit status is 0 when any difference was found and 1 when none
was (main-diff.c:43, the regression-test discipline of the reference,
diff.c:98-99). A pass that fails (a kernel that does not build or
launch, a CUDA error) prints its traceback and exits 2, so it never
reads as either answer.
"""

from __future__ import annotations

import math
import sys
import traceback

from .. import filters, stats
from ..assembler import BatchAssembler
from ..io import fastq as fq
from ..nt import nt_to_ascii
from . import main as cli_main

DIFF_BATCH = 1024


def _assemble_all(c, pairs):
    asm = BatchAssembler(c.cfg, L=512, modules=c.modules)
    results = []
    for i in range(0, len(pairs), DIFF_BATCH):
        for code, res in asm.assemble_batch(pairs[i:i + DIFF_BATCH]):
            results.append(res if code == "OK" else None)
    return results


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    sections = [[]]
    for a in argv:
        if a == "--":
            sections.append([])
        else:
            sections[-1].append(a)
    while len(sections) < 3:
        sections.append([])
    common, control, experiment = sections[0], sections[1], sections[2]

    verbose = "-v" in common
    common = [a for a in common if a != "-v"]

    try:
        base = cli_main.parse_args(common, prog="pandaseq-diff")
        ctl = cli_main.parse_args(common + control, prog="pandaseq-diff")
        exp = cli_main.parse_args(common + experiment,
                                  prog="pandaseq-diff")
    except cli_main.ArgsError:
        print("Too confused to continue.\nTry -h for help.",
              file=sys.stderr)
        return 1
    except SystemExit as e:
        return int(e.code or 0)
    if base.fwd_file is None or base.rev_file is None:
        print("You must supply both forward and reverse reads.",
              file=sys.stderr)
        return 1

    logger = stats.LogProxy(debug_flags=0)
    for cfg in (ctl, exp):
        try:
            for kind, arg in cfg.module_specs:
                if kind == "C":
                    cfg.modules.append(filters.load_module(arg, logger))
                elif kind == "N":
                    cfg.modules.append(filters.degenerates_module())
                elif kind == "l":
                    cfg.modules.append(filters.short_module(arg))
                elif kind == "L":
                    cfg.modules.append(filters.long_module(arg))
        except filters.ModuleError:
            return 1

    pairs = []
    reader = fq.read_pairs(base.fwd_file, base.rev_file,
                           qualmin=base.qualmin, policy=base.policy)
    while True:
        try:
            pairs.append(next(reader))
        except (StopIteration, fq.StreamError):
            break

    try:
        ctl_res = _assemble_all(ctl, pairs)
        exp_res = _assemble_all(exp, pairs)
    except Exception:
        traceback.print_exc()
        return 2

    w = sys.stdout.write
    length_diffs = nt_diffs = better = worse = gained = lost = 0
    total = 0
    for pair, cr, er in zip(pairs, ctl_res, exp_res):
        total += 1
        sid = str(pair.sid)
        if cr is None and er is None:
            continue
        if cr is None or er is None:
            if cr is None:
                gained += 1
                w("%s has been gained.\n" % sid)
            else:
                lost += 1
                w("%s has been lost.\n" % sid)
            continue
        if cr.quality < er.quality:
            better += 1
        elif cr.quality > er.quality:
            worse += 1
        if er.sequence_length != cr.sequence_length:
            length_diffs += 1
            w("%s differ in length %d → %d.\n"
              % (sid, cr.sequence_length, er.sequence_length))
        else:
            nt_diff = False
            ca = nt_to_ascii(cr.sequence_nt[:cr.sequence_length])
            ea = nt_to_ascii(er.sequence_nt[:er.sequence_length])
            for it in range(er.sequence_length):
                if ca[it] != ea[it]:
                    w("%s differ at nucleotide %d, %c → %c.\n"
                      % (sid, it, ca[it], ea[it]))
                    nt_diff = True
                elif cr.sequence_p[it] != er.sequence_p[it] and verbose:
                    w("%s differ at nucleotide %d (%c), quality %f → "
                      "%f.\n" % (sid, it, ca[it],
                                 math.exp(cr.sequence_p[it]),
                                 math.exp(er.sequence_p[it])))
                    nt_diff = True
            if nt_diff:
                nt_diffs += 1
    w("%d sequences compared.\n%d scored better.\n%d scored worse.\n"
      "%d changed (%d length changed, %d sequence changed).\n%d gained.\n"
      "%d lost.\n" % (total, better, worse, nt_diffs + length_diffs,
                      length_diffs, nt_diffs, gained, lost))
    # faithful inversion: main-diff.c:43 `return result ? 0 : 1` exits 0
    # when panda_diff reported differences and 1 on a clean comparison
    return 0 if (total == 0 or length_diffs > 0 or nt_diffs > 0
                 or gained > 0 or lost > 0) else 1


if __name__ == "__main__":
    sys.exit(main())
