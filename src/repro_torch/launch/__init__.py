"""Launchers (port of `repro.launch`): the card's roofline constants
(`mesh`) and the serving driver (`serve`). Training, the dry run and the
mesh construction wait for the distributed layer."""
