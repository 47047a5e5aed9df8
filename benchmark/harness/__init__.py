"""The benchmark's general code: finding a cell's parts by name (`spec`),
seeded weights (`weights`) and inputs (`data`), the statistics
(`stats`), the profiler trace and its reading (`trace`), and the run
itself (`run`)."""
