"""The trainer of the port: data, optimizers, gradient compression,
checkpoints and the training loop (`training.train_loop.Trainer`), on
one device.  The counterpart of `repro.training`."""
