"""The network of the port: the DP server, the client, the wire protocol."""
