"""The trainers and datasets the benchmark fits its models with.

A frozen copy of the port's numpy-only trainers (CART trees, bagging
forests, linear SVMs, the quantizer) and of its seeded dataset stand-ins.
The models are the benchmark's inputs: keeping the code that makes them
here means no change to the program's trainers can change the work a cell
measures.  ``portbench.deploy`` hands the fitted models to the program as
the program's own model objects.
"""
from portbench.trainers.cart import DecisionTree, TreeArrays
from portbench.trainers.forest import RandomForest
from portbench.trainers.linsvm import LinearSVM
from portbench.trainers.quantize import Quantizer
from portbench.trainers.synth import load_dataset

__all__ = ["DecisionTree", "TreeArrays", "RandomForest", "LinearSVM",
           "Quantizer", "load_dataset"]
