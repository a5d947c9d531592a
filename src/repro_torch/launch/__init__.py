"""Step builders of the port (`launch.steps`: the train, prefill and
decode steps on one device or a mesh, and `lower_cell`), its meshes
(`launch.mesh`) and the dry run over every (arch x shape x mesh) cell
(`launch.dryrun`).  The counterpart of `repro.launch`."""
