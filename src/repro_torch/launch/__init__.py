"""Step builders of the port (`launch.steps`), on one device.  The
counterpart of `repro.launch`; its mesh, dry-run and lowering wait for
the distributed slice (ROADMAP A9)."""
