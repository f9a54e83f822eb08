#!/usr/bin/env python3
"""EPIK: Evolutionary Placement with Informative K-mers, on an accelerator.

Drop-in replacement for the reference's top-level CLI wrapper
(reference: epik.py): same ``place`` command and flag surface, but the
engine is the in-process JAX pipeline rather than a subprocess exec of a
compiled epik-dna/epik-aa binary (reference: epik.py:78-98) -- the state
alphabet is runtime data here, not a compile-time template choice.
"""

import sys

from epik_tpu.cli.main import main

if __name__ == "__main__":
    sys.exit(main())
