"""Networks of the port: nn.Modules with the reference's state_dict names."""
