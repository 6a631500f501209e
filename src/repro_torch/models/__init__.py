"""Models built on the CNNLab middleware: AlexNet, and weight conversion from
numpy arrays."""
