"""pandaseq-checkid (main-parse.c): diagnose sequence-header parsing.

The port's own copy of ``pandaseq_tpu/cli/checkid.py``, over the port's
``seqid`` (``parse_fail``, ``fmt_has_direction``); its output and exit
status are the JAX tool's, byte for byte. It needs no card.
"""

from __future__ import annotations

import sys

from .. import seqid
from .main import VERSION

_GENERATOR = {  # panda_idfmt_str (seqid.c:24-40)
    seqid.FMT_EBI_SRA: "EBI Short Read Archive",
    seqid.FMT_SRA: "NCBI Short Read Archive",
    seqid.FMT_CASAVA_1_4: "CASAVA 1.4-1.6",
    seqid.FMT_CASAVA_CONVERTED: "CASAVA converted",
    seqid.FMT_CASAVA_1_7: "CASAVA 1.7+",
    None: "unknown",
}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = [a for a in argv if not a.startswith("-")]
    if "-v" in argv:
        print("%s <pandaseq_tpu>" % VERSION, file=sys.stderr)
        return 1
    if not args or "-h" in argv:
        print("%s <pandaseq_tpu>\nUsage: pandaseq-checkid \"seq header\" "
              "...\nCheck is the sequence header is recognised by "
              "PANDAseq." % VERSION, file=sys.stderr)
        return 1
    for arg in args:
        s = arg[1:] if arg.startswith("@") else arg
        direction, sid, fmt, endpos = seqid.parse_fail(
            s, seqid.TAG_OPTIONAL)
        if direction == 0:
            print(arg)
            # main-parse.c:80: endptr - argv[it] - 2 spaces, then '^'
            print(" " * max(endpos + (1 if arg.startswith("@") else 0) - 2,
                            0) + "^")
            print("\tBAD")
        else:
            print(str(sid))
            print("\tGOOD\n\tdirection = %s\n\thastag = %s" % (
                ("forward" if direction == 1 else "reverse")
                if seqid.fmt_has_direction(fmt) else "unknown",
                "no" if sid.tag == "" else "yes"))
        print("\tinstrument = \"%s\"\n\trun = \"%s\"\n\tflowcell = \"%s\""
              "\n\tlane = %d\n\ttile = %d\n\tx = %d\n\ty = %d\n\ttag = "
              "\"%s\"\n\tgenerator = %s"
              % (sid.instrument, sid.run, sid.flowcell, sid.lane, sid.tile,
                 sid.x, sid.y, sid.tag, _GENERATOR.get(fmt, "unknown")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
