"""The harness: what every cell shares (spec, fits, trace, check)."""
