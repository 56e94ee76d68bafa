"""One-shot serving: the runahead sampler and the generate loop."""
