"""Query engines (the quantized-adjacency walk)."""
