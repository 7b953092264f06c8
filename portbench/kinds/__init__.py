"""Traffic kinds, one module each: `setup`, `request`, `layer_inputs`,
`check` and `control`, and the `FAMILY` the metric readers know it by."""
