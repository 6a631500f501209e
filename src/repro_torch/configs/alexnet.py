"""AlexNet — the paper's own experimental network (Table I), CNN family.

Runs through the CNNLab core (layer tuples -> scheduler -> engines), not the
transformer; LM shapes do not apply.
"""
FAMILY = "cnn"
CONFIG = None
SMOKE = None
LR_SCHEDULE = "cosine"
