"""The plain reference of a request: plain PyTorch and a scipy KD-tree,
written from the equations of the reference simulation (polytrope_sim.jl,
polytrope_hydroKDTree.jl, gravOctree_Single.jl at theta -> 0). It imports
nothing of the program under test and takes nothing the program made.
"""
