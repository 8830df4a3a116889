"""ACORN core: the paper's contribution (port of ``repro.core``).

    mlmodels/    trainable model classes (CART, forest, SVM) — numpy copies
    tables.py    the 5 pre-defined MAT types + TCAM prefix expansion (copy)
    translator.py trained model -> TableProgram (copy)
    packets.py   ACORN header as a batch of tensors
    plane.py     runtime-programmable switch engine: one kernel per classify,
                 or three / L + 2 in the staged modes
    topology.py  datacenter topologies for the planner (copy)
    planner.py   ILP / DP placement of program stages on a path (copy)
    distributed_plane.py  a plan -> per-switch partial programs
    netsim.py    latency / overhead / availability model, J_L (copy)
    baselines/   the paper's comparison systems (SwitchTree, LEO, DINC) and
                 Table 3's feature limits (copy)
"""
