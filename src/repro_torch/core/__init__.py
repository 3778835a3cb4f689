"""Framework-free foundations and the Alg. 2 predictor (port of `repro.core`)."""
