"""The scene data plane: scene JSON -> meshes -> model-ready tensors and H5
files, and the path tracer that renders their ground truth on the card."""
