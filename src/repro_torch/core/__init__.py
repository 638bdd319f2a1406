"""The exit decision (confidence, policy), MAC accounting and the staged
cascade executor."""
