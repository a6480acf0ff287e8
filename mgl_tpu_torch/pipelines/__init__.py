"""The port's pipelines: the read mapper and align + sort."""
