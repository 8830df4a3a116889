"""The plain NumPy reference that decides ``correct``.

It imports nothing of the program: it reads the models' own arrays (tree
nodes, thresholds, leaves, forest weights, SVM weights) as the benchmark's
trainers made them, and the packets the harness hands to both sides.
"""
from portbench.reference.classify import (
    FORWARD,
    MID_SVM,
    REQUEST,
    classify,
    coarsen,
    svm_luts,
    walk,
)

__all__ = ["FORWARD", "REQUEST", "MID_SVM", "classify", "coarsen",
           "svm_luts", "walk"]
