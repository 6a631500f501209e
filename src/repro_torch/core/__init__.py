"""CNNLab core in PyTorch.

Layer tuples -> device models -> cost model -> engine registry -> DSE
scheduler -> execution plan -> trade-off analysis.
"""
