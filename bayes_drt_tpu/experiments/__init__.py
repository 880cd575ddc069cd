"""Exploratory sampler arms, kept importable but fenced.

None of them is reachable from a default-configured production fit; all
remain covered by the test suite. Earlier measurements ranked each below
the production path; their records are gone, so what is said here is the
design argument, and the numbers on the current hardware belong in PERF.md.

**ChEES-HMC** (`sample_chees`, `ChEESConfig`; `Inverter.fit(sampler='chees')`
and `fit_spectra_batch(sampler='chees')` route here).
Adaptive trajectory-length HMC (Hoffman et al. 2021). The per-chain and
per-spectrum trajectory lengths diverge under vmap, so every draw costs the
BATCH MAX of the while_loop trip counts, and endpoint-MH acceptance is
fragile in the ups-funnel (one divergent endpoint rejects the whole draw).
Kept: the warmup machinery (per-chain step-size adaptation) is shared with
the production SHMC, and ChEES is the right sampler for posteriors without
the funnel geometry.

**NUTSConfig(fused_draws=True)** (`bayes_drt_tpu.infer.nuts`).
One persistent while_loop per whole chain instead of one per draw. The
per-leapfrog masked dual-averaging/draw-write bookkeeping outweighed the
per-draw sync it saves. Kept: API completeness; it is the canonical "no
host sync at all" form.

**SHMCConfig(flat_chain=True)** (`bayes_drt_tpu.infer.shmc_flat`,
`sample_shmc_flat`).
The production sampler over one flat (B*C, D) chain axis with a
hand-written posterior gradient. `benchmarks/ab_flat_chain.py` times it
against the generic path. Kept: `flat_value_and_grad` is the only
from-first-principles check of the posterior gradient, and the flat layout
is where a fused trajectory kernel would start.

Production API: `fit_spectra_batch(sampler='shmc')` (bench default) and
`sampler='nuts'` (Stan-equivalent). Everything imported below is
experimental.
"""

from ..infer.chees import ChEESConfig, sample_chees
from ..infer.shmc_flat import (FlatShared, FlatSpec, flat_shared_for,
                               flat_spec_for, flat_value_and_grad,
                               sample_shmc_flat)

__all__ = [
    "ChEESConfig", "sample_chees",
    "FlatShared", "FlatSpec", "flat_shared_for", "flat_spec_for",
    "flat_value_and_grad", "sample_shmc_flat",
]
