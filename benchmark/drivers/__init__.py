"""One module a step kind, named by a traffic file's ``step``: each holds
a ``Driver`` (on ``base.Driver``) that counts a request's windows and its
work by layer from the configuration and the traffic, builds the program
for a configuration, prepares a seeded run (weights, traffic, the checked
requests), serves one request at a time for the window, and compares its
outputs with the plain reference."""
