"""The port's serving processes: the resident kernel server
(``server.kernel_server``)."""
