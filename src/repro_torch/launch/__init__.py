"""Step builders of the port (`launch.steps`: the train step on one
device or a mesh, the prefill and decode steps on one device) and its
meshes (`launch.mesh`).  The counterpart of `repro.launch`; the dry run
and `lower_cell` wait for slice 16 (ROADMAP A9)."""
