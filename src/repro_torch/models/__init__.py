"""Models of the port: layers as torch functions, blocks as ``nn.Module``s
whose parameters carry the JAX package's parameter-tree names."""
