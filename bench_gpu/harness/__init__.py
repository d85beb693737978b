"""The harness: the manifest, set-up and window helpers, tracing, metric
readers and the result line. Nothing here imports the program at module
level; the drivers import it once a card is found."""
