"""Model configurations, the port's own copies of the JAX package's
``configs`` (which import the JAX ``ModelConfig``)."""
