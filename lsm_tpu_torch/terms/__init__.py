"""Hamilton-Jacobi terms."""
