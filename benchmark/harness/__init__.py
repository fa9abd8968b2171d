"""The benchmark's harness: inputs from the seed, the measured window of
CLI jobs, the traced run's spans and device trace, and the check against
the plain reference. ``run.py`` beside this package is its entry."""
