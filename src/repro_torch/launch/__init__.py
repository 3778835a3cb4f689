"""Launchers (port of `repro.launch`): the cell mesh of sharded sweeps
and the card's roofline constants (`mesh`), the Figs. 5-7 sensitivity
grid (`spork_sim`) and the serving driver (`serve`). Training, the dry
run and the production meshes wait for the distributed layer."""
