"""Recognition backbones and the weight converter from the JAX package."""
