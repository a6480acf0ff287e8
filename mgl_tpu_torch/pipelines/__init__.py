"""The port's pipelines: the read mapper, align + sort and the chunk
checkpoint ledger."""
