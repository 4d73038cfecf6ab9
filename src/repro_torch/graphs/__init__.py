"""Graph containers, generators and block packings (numpy; tiles in torch)."""
