"""Framework-free foundations, the Alg. 2 predictor and the Table 3 min-plus
DP with its MILP oracle (port of `repro.core`)."""
