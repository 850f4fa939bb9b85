"""Grid, boundary conditions and fields."""
