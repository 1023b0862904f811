"""Scripts of the port: cluster selection and auto-labelling, and kernel
measurement on a GPU."""
