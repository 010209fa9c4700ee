"""Numeric phases of the port: tile kernels, the left-looking E2 update
(K1), the LLᵗ factorization and the sweep solve (K2)."""
