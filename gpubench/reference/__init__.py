"""Plain references for the benchmark's correctness check: fixed points
computed from the generated edge list and queries alone, in torch ops and
float64. Nothing here imports the program under test."""
