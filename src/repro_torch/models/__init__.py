"""Models: AlexNet on the CNNLab middleware, the dense transformer (qwen2's
path) with its layers and attention engines, and weight conversion from
numpy arrays."""
