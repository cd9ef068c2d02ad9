"""Each method's term of the plain reference's loss, one file a method,
found by the method's name in a traffic file."""
