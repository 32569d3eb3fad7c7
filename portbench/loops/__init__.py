"""The general loops that the traffic files name by their ``loop``."""
