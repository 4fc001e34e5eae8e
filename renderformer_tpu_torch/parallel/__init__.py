"""More than one GPU: process groups, the (data, seq) mesh, and sequence-split
and ring attention over the mesh's ``seq`` axis."""
