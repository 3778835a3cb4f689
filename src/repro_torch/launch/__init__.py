"""Launchers (port of `repro.launch`): the production and host meshes,
the cell mesh of sharded sweeps and the card's roofline constants
(`mesh`), the Figs. 5-7 sensitivity grid (`spork_sim`), the serving
driver (`serve`) and the resumable training driver (`train`). The dry
run is not ported yet."""
