"""The M-DSL engine: losses, Eq.-2 non-i.i.d. degree, selection, PSO,
the round pipeline, the paper round (`mdsl.mdsl_round`) and the
population engine (`population`)."""
