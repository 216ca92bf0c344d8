# Stage engines: imported lazily by the CLI to keep startup light.
