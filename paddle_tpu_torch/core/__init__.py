"""Core pieces of the port shared by its models and serving path:
`random`, the counter-based threefry2x32 stream the JAX package draws
its sampled tokens from."""
