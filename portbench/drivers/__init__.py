"""One driver a task: ``run(ctx)`` makes the cell's inputs from the seed,
builds the port's state, drives its first steps and warm-up (set-up), the
measured window, and the comparison with the reference."""
