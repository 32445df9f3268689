"""Traffic generators, all seeded from ``--seed``: frozen copies of the
repository's stream and clip synthesizers."""
