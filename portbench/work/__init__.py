"""Frozen arithmetic of the benchmark: operations and bytes computed from
shapes, and the card's published peaks. Nothing here imports the
program; later changes to the program cannot move these numbers."""
