"""ACORN core: the paper's contribution (port of ``repro.core``).

    mlmodels/    trainable model classes (CART, forest, SVM) — numpy copies
    tables.py    the 5 pre-defined MAT types + TCAM prefix expansion (copy)
    translator.py trained model -> TableProgram (copy)
    packets.py   ACORN header as a batch of tensors
    plane.py     runtime-programmable switch engine, one kernel per classify
"""
