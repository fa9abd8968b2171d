"""The benchmark's plain reference of a PANDAseq merge.

``oracle``, ``tables`` and ``nt`` are frozen copies of the port's pure
Python oracle; ``merge`` adds a FASTQ reader, the CLI's flag subset and
the text the CLI prints for one pair. Nothing here imports the port,
``pandaseq_tpu``, JAX or torch.
"""
