"""Query engines: the row engine (f32 rows) and the quantized-adjacency
(fused) walk."""
